"""Top-level command dispatcher of the port.

  python -m syllable_detector_tpu_torch detect    ...   (cli.py — offline detection)
  python -m syllable_detector_tpu_torch train     ...   (train.py)
  python -m syllable_detector_tpu_torch sim       ...   (sim.py)
  python -m syllable_detector_tpu_torch monitor   ...   (monitor.py)
  python -m syllable_detector_tpu_torch inspect   ...   (inspect_net.py)
  python -m syllable_detector_tpu_torch dist-scan ...   (dist_scan.py)
  python -m syllable_detector_tpu_torch tune      ...   (tuning.py)
"""

import sys

COMMANDS = {
    "detect": ("syllable_detector_tpu_torch.cli", "offline detection CLI"),
    "train": ("syllable_detector_tpu_torch.train", "train a detector from labeled audio"),
    "sim": ("syllable_detector_tpu_torch.sim", "render a detection-signal WAV"),
    "monitor": ("syllable_detector_tpu_torch.monitor", "live multi-channel monitor"),
    "inspect": ("syllable_detector_tpu_torch.inspect_net", "summarize a network file"),
    "dist-scan": (
        "syllable_detector_tpu_torch.dist_scan",
        "multi-process corpus scan (torch.distributed, sharded file list)",
    ),
    "tune": (
        "syllable_detector_tpu_torch.tuning",
        "time the fused kernel's launch shapes on this card and cache the winners",
    ),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m syllable_detector_tpu_torch COMMAND ...\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:8s} {desc}")
        return 0 if argv and argv[0] in ("-h", "--help") else 2

    import importlib

    module = importlib.import_module(COMMANDS[argv[0]][0])
    return module.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
