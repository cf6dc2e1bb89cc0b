"""Offline detection CLI on PyTorch — the port's main path.

Counterpart of ``syllable_detector_tpu.cli`` (the reference CLI's
contract): load one network config, run each audio file's tracks through
per-track detectors, and write a comma-separated detection event per line
to stdout:

    0,1593298,36.1292063492063,0.918557

Columns: track/channel number (from 0), sample number, timestamp in seconds,
then one column per network output. When several audio files are given,
each file's path is printed before its events. Errors go to stderr and
processing continues with the next file.

A file whose sample rate differs from the network's is resampled to the
network rate per channel by the polyphase resampler (the framed GEMM kernel
on a card), unless ``--no-resample`` asks to process it at the network
rate. ``--batched`` scans all files in one device computation
(``corpus.scan_corpus_files``; ``--batch-files N`` in groups of N files).

Usage:  python -m syllable_detector_tpu_torch.cli -n NET.txt -a FILE.wav
            [-a ...] [-d SECONDS] [--method matmul|rfft|fused]
            [--batched [--batch-files N]] [--no-resample]
            [--device cuda|cpu]

The device defaults to ``cuda``; without a card the CLI raises rather than
move to the CPU, which is only used when asked for (``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import ConfigError, load_config
from syllable_detector_tpu_torch.corpus import resample_channels, scan_corpus_files
from syllable_detector_tpu_torch.models.detector import detector_spec_from_config
from syllable_detector_tpu_torch.runtime.track_detector import TrackDetector
from syllable_detector_tpu_torch.utils.wav import read_audio

__all__ = ["main", "run_file"]

# samples per simulated decode buffer (the JAX CLI's; output is chunk-size
# invariant)
CHUNK = 65536


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="syllable-detector-torch",
        description="Syllable detection over audio files (PyTorch/CUDA).",
        epilog=(
            "The command line will write a comma-separated list of detection "
            "events (when the network has at least one output above "
            "threshold) to standard out. Columns: 1. track/channel number "
            "(starting with 0); 2. sample number of the detection; 3. "
            "timestamp of the detection; 4+. the neural network outputs."
        ),
    )
    p.add_argument(
        "-n",
        "--net",
        action="append",
        required=True,
        help="Path to trained network file; repeat to give each audio "
        "channel its own network (cycled per channel; all nets must share "
        "the first net's geometry).",
    )
    p.add_argument(
        "-a",
        "--audio",
        action="append",
        default=[],
        help="Path to the audio file to process (repeatable).",
    )
    p.add_argument(
        "-d",
        "--debounce",
        type=float,
        default=None,
        help="Number of seconds to debounce triggers.",
    )
    p.add_argument(
        "--method",
        choices=("matmul", "rfft", "fused"),
        default="matmul",
        help="Spectral backend (default: band DFT as one matmul; 'fused' = "
        "the fused CUDA detection kernel).",
    )
    p.add_argument(
        "--batched",
        action="store_true",
        help="Batched corpus mode: all files in one device computation "
        "(with --method fused, one launch of the fused CUDA kernel).",
    )
    p.add_argument(
        "--batch-files",
        type=int,
        default=None,
        metavar="N",
        help="With --batched: scan the corpus in groups of N files "
        "(bounds memory on huge corpora; output order unchanged).",
    )
    p.add_argument(
        "--mesh",
        action="store_true",
        help="Batched mode only: shard the lanes across the visible CUDA "
        "devices, one shard per device (with --device cpu: one CPU shard).",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="Torch device to run on (default: cuda).",
    )
    p.add_argument(
        "--no-resample",
        action="store_true",
        help="Do not resample rate-mismatched files to the network rate; "
        "process them at the network rate instead.",
    )
    return p


def run_file(
    audio_path: str,
    config,
    debounce: float | None,
    emit=print,
    err=None,
    method: str = "matmul",
    resample: bool = True,
    device="cuda",
) -> bool:
    """Sequential per-file scan. ``config`` may be a sequence of configs:
    channel c uses ``configs[c % len(configs)]`` (the first net's rate
    drives any resampling, which runs on ``device``)."""
    configs = list(config) if isinstance(config, (list, tuple)) else [config]
    config = configs[0]
    err = err if err is not None else (lambda s: print(s, file=sys.stderr))
    try:
        samples, rate = read_audio(audio_path)
    except (OSError, ValueError) as e:
        err(f"Unable to read {audio_path}: {e}")
        return False

    n, channels = samples.shape
    if channels < 1 or n == 0:
        err(f"No audio tracks found in {audio_path}.")
        return False

    if rate != config.sampling_rate and resample:
        err(
            f"Resampling {audio_path} from {rate} Hz to the network rate "
            f"{config.sampling_rate} Hz."
        )
        samples = resample_channels(samples, rate, config.sampling_rate, device)
        n = samples.shape[0]
    elif rate != config.sampling_rate:
        err(
            f"Warning: {audio_path} sample rate {rate} != network rate "
            f"{config.sampling_rate}; processing at the network rate."
        )

    detectors = [
        TrackDetector(
            configs[i % len(configs)], channel=i, emit=emit, method=method,
            device=device,
        )
        for i in range(channels)
    ]
    if debounce is not None:
        for d in detectors:
            d.debounce_time = debounce

    # synchronous read loop over fixed-size buffers
    for start in range(0, n, CHUNK):
        chunk = samples[start : start + CHUNK]
        for i, det in enumerate(detectors):
            det.process(np.ascontiguousarray(chunk[:, i]))
    return True


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
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
        configs = [load_config(n) for n in args.net]
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1

    try:
        specs = [
            dataclasses.replace(
                detector_spec_from_config(c, "cpu")[0], thresholds=()
            )
            for c in configs
        ]
    except ValueError as e:
        print(f"Invalid network configuration: {e}", file=sys.stderr)
        return 1
    for path, spec in zip(args.net[1:], specs[1:]):
        if spec != specs[0]:
            print(
                f"Network {path} does not share the first network's "
                f"geometry (sampling rate, FFT/window, band, layer sizes).",
                file=sys.stderr,
            )
            return 1

    if args.batched:
        mesh = None
        if args.mesh:
            from syllable_detector_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(devices=[device] if device.type == "cpu" else None)
            print(f"Mesh: {mesh}.", file=sys.stderr)
        scan_corpus_files(
            configs,
            args.audio,
            debounce_seconds=args.debounce,
            method=args.method,
            mesh=mesh,
            resample=not args.no_resample,
            group_files=args.batch_files,
            device=device,
        )
        return 0

    multiple = len(args.audio) > 1
    for audio_path in args.audio:
        if multiple:
            print(audio_path)
        run_file(
            audio_path,
            configs,
            args.debounce,
            method=args.method,
            resample=not args.no_resample,
            device=device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
