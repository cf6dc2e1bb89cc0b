"""Offline simulator on PyTorch: audio file in -> detection-signal WAV out.

Counterpart of ``syllable_detector_tpu.sim``: stream a file through one
detector and write a mono WAV whose value over each hop region is
clamp(out0 / threshold0, 0, 1), with the initial
``window + hop*(timeRange-1)`` samples zero-filled (the region before the
first network evaluation). Per-hop ingest/process latencies are recorded
through :class:`Time` and printed at the end.

Usage: python -m syllable_detector_tpu_torch.sim -n NET.txt -a IN.wav -o OUT.wav
           [--channel C] [--method matmul|rfft|fused] [--device cuda|cpu]

The device defaults to ``cuda``; without a card the simulator raises rather
than move to the CPU, which is only used when asked for (``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import ConfigError, load_config
from syllable_detector_tpu_torch.models.detector import Detector
from syllable_detector_tpu_torch.utils.timing import Time
from syllable_detector_tpu_torch.utils.wav import read_audio, write_wav

__all__ = ["simulate", "main"]


def simulate(
    config, samples: np.ndarray, chunk: int = 8192, method: str = "matmul", device="cuda"
) -> np.ndarray:
    """Run the detector over ``samples`` and render the detection signal.

    Output has the same length as the input: zeros for the initial
    pre-first-decision region, then hop-length runs of
    clamp(out0/threshold0, 0, 1), zero beyond the final full hop region.
    """
    samples = np.asarray(samples, np.float32).reshape(-1)
    n = len(samples)
    det = Detector(config, method=method, device=device)
    threshold0 = np.float32(config.thresholds[0])
    hop = config.window_length - config.window_overlap  # region length per eval
    first = config.first_output_sample

    signal = np.zeros(n, np.float32)
    outputs = []
    for start in range(0, n, chunk):
        Time.start_with_name("ingest")
        det.append_audio_data(samples[start : start + chunk])
        Time.stop_and_save_with_name("ingest")
        Time.start_with_name("process")
        outs = det.drain()
        elapsed = Time.stop_and_save_with_name("process")
        if len(outs) == 0:
            Time.save_with_name("skip", elapsed)
        outputs.append(outs)

    outs = (
        np.concatenate(outputs) if outputs else np.zeros((0, 1), np.float32)
    )
    v = np.clip(outs[:, 0] / threshold0, 0.0, 1.0)
    for e, value in enumerate(v):
        lo = first + e * hop
        if lo >= n:
            break
        signal[lo : min(lo + hop, n)] = value
    return signal


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="syllable-detector-torch-sim",
        description=(
            "Simulate a detector over an audio file and write the detection "
            "signal as a WAV (value per hop = clamp(output/threshold, 0, 1))."
        ),
    )
    p.add_argument("-n", "--net", required=True, help="Path to trained network file.")
    p.add_argument("-a", "--audio", required=True, help="Input audio file.")
    p.add_argument("-o", "--output", required=True, help="Output WAV path.")
    p.add_argument("--channel", type=int, default=0, help="Input channel to use.")
    p.add_argument("--method", choices=("matmul", "rfft", "fused"), default="matmul")
    p.add_argument("--device", default="cuda", help="Torch device to run on (default: cuda).")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    # full fp32 products, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        config = load_config(args.net)
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1

    try:
        samples, rate = read_audio(args.audio)
    except (OSError, ValueError) as e:
        print(f"Unable to read {args.audio}: {e}", file=sys.stderr)
        return 1

    if args.channel >= samples.shape[1]:
        print(f"No channel {args.channel} in {args.audio}.", file=sys.stderr)
        return 1

    signal = simulate(config, samples[:, args.channel], method=args.method, device=device)
    # 16-bit mono at the detector rate
    write_wav(args.output, signal, int(config.sampling_rate), dtype="int16")
    Time.print_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
