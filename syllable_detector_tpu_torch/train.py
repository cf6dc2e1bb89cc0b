"""Training CLI on PyTorch — train a detector from labeled audio and export
the net.

Counterpart of ``syllable_detector_tpu.train``, the native replacement for
the reference's MATLAB training + convert_to_text.m export loop. Labels are
a CSV of ``start_seconds,end_seconds`` syllable intervals (lines starting
with ``#`` ignored). The exported text network loads in both packages' CLIs
and in the reference Swift app.

Usage:
  python -m syllable_detector_tpu_torch.train -a song.wav -l labels.csv -o net.txt
         [--epochs N] [--hidden 4] [--fft 256] [--overlap 124]
         [--freq 2000 7000] [--time-range 10] [--data-parallel]
         [--device cuda|cpu]

Repeat -a/-l in pairs to train one DISTINCT net per channel together (an
ensemble stacked on a leading axis). -o then takes a ``{ch}`` placeholder
(or gets ``_<ch>`` inserted before its extension); --channel-parallel
shards the channel ensemble across the visible cards.

The device defaults to ``cuda``; without a card the CLI raises rather than
move to the CPU, which is only used when asked for (``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import save_config
from syllable_detector_tpu_torch.training.trainer import (
    TrainSettings,
    export_trained_config,
    features_and_labels,
    train,
)
from syllable_detector_tpu_torch.utils import timing
from syllable_detector_tpu_torch.utils.wav import read_audio

__all__ = ["main", "read_labels"]


def read_labels(path: str) -> list[tuple[float, float]]:
    intervals = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 2:
                continue
            intervals.append((float(parts[0]), float(parts[1])))
    return intervals


def _mesh(axis: str, device: torch.device):
    """One shard per visible card (one CPU shard with ``--device cpu``)."""
    from syllable_detector_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis=axis, devices=[device] if device.type == "cpu" else None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="syllable-detector-torch-train")
    p.add_argument("-a", "--audio", required=True, action="append",
                   help="Training audio WAV (repeat for per-channel nets).")
    p.add_argument("-l", "--labels", required=True, action="append",
                   help="CSV of start_seconds,end_seconds syllable intervals "
                        "(one per -a).")
    p.add_argument("-o", "--output", required=True,
                   help="Output network file; with multiple -a/-l pairs, a "
                        "{ch} placeholder or an auto _<ch> suffix.")
    p.add_argument("--channel", type=int, default=0)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=3e-3)
    p.add_argument("--hidden", type=int, nargs="+", default=[4])
    p.add_argument("--fft", type=int, default=256)
    p.add_argument("--window", type=int, default=None)
    p.add_argument("--overlap", type=int, default=124)
    p.add_argument("--freq", type=float, nargs=2, default=[2000.0, 7000.0])
    p.add_argument("--time-range", type=int, default=10)
    p.add_argument("--scaling", choices=("linear", "log", "db"), default="linear")
    p.add_argument(
        "--input-processing", default="l2normalize,mapminmax",
        metavar="NAMES",
        help="comma-separated input chain to fit and export "
        "(convert_to_text.m's prepended names + processFcns): "
        "parameter-free stages (l2normalize/normalize/normalizestd/"
        "passthrough) followed by fitted affines (mapminmax/mapstd). "
        "Default: l2normalize,mapminmax — the reference's deployed chain.",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", action="store_true",
                   help="Shard batches across the visible cards "
                        "(single-net mode).")
    p.add_argument("--channel-parallel", action="store_true",
                   help="Shard the per-channel net ensemble across the "
                        "visible cards (multi-pair mode).")
    p.add_argument("--checkpoint-dir", default=None,
                   help="Checkpoint directory: save every "
                        "--checkpoint-every epochs and RESUME exactly "
                        "from the latest checkpoint if one exists.")
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default: cuda).")
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

    if len(args.audio) != len(args.labels):
        print(
            f"-a and -l must pair up ({len(args.audio)} audio, "
            f"{len(args.labels)} label files).",
            file=sys.stderr,
        )
        return 1

    multi = len(args.audio) > 1
    if args.channel_parallel and not multi:
        print("--channel-parallel requires multiple -a/-l pairs "
              "(use --data-parallel for a single net).", file=sys.stderr)
        return 1
    if args.data_parallel and multi:
        print("--data-parallel applies to single-net training; with "
              "multiple -a/-l pairs use --channel-parallel.", file=sys.stderr)
        return 1

    feats_list, labels_list = [], []
    rate = None
    settings = None
    for audio_path, labels_path in zip(args.audio, args.labels):
        with timing.span("train.read"):
            try:
                samples, r = read_audio(audio_path)
            except (OSError, ValueError) as e:
                print(f"Unable to read {audio_path}: {e}", file=sys.stderr)
                return 1
            try:
                intervals = read_labels(labels_path)
            except (OSError, ValueError) as e:
                print(f"Unable to read {labels_path}: {e}", file=sys.stderr)
                return 1
        if not intervals:
            print(f"No labeled intervals in {labels_path}.", file=sys.stderr)
            return 1
        if args.channel >= samples.shape[1]:
            print(f"No channel {args.channel} in {audio_path}.",
                  file=sys.stderr)
            return 1
        if rate is None:
            rate = r
            try:
                settings = TrainSettings(
                    sampling_rate=float(rate),
                    fourier_length=args.fft,
                    window_length=(
                        args.window if args.window is not None else args.fft
                    ),
                    window_overlap=args.overlap,
                    freq_range=(args.freq[0], args.freq[1]),
                    time_range=args.time_range,
                    scaling=args.scaling,
                    input_processing=tuple(
                        s.strip() for s in args.input_processing.split(",")
                        if s.strip()
                    ),
                    hidden=tuple(args.hidden),
                    learning_rate=args.learning_rate,
                    epochs=args.epochs,
                    batch_size=args.batch_size,
                    seed=args.seed,
                )
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 1
        elif r != rate:
            print(
                f"{audio_path} sample rate {r} differs from {rate}; all "
                f"channels must share one rate.",
                file=sys.stderr,
            )
            return 1

        audio = np.ascontiguousarray(samples[:, args.channel])
        with timing.span("train.features"):
            feats, labels = features_and_labels(settings, audio, intervals, device)
        n_pos = int(labels.sum())
        if not args.quiet:
            print(
                f"{audio_path}: {len(feats)} evaluations ({n_pos} positive) "
                f"from {len(audio)/rate:.1f}s of audio; "
                f"{settings.n_features} features"
            )
        if n_pos == 0 or n_pos == len(labels):
            print(
                f"Labels for {audio_path} must contain both positive and "
                f"negative spans.",
                file=sys.stderr,
            )
            return 1
        feats_list.append(feats)
        labels_list.append(labels)

    if len(feats_list) == 1:
        mesh = _mesh("data", device) if args.data_parallel else None
        try:
            with timing.span("train.trainer"):
                net_spec, params, threshold = train(
                    settings, feats_list[0], labels_list[0], mesh=mesh,
                    verbose=not args.quiet,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    device=device,
                )
        except ValueError as e:
            # checkpoint-dir fingerprint mismatches etc. are user errors,
            # not tracebacks
            print(str(e), file=sys.stderr)
            return 1
        # honor a {ch} template even with one pair
        out = (
            _channel_output_path(args.output, 0)
            if "{ch}" in args.output
            else args.output
        )
        with timing.span("train.export"):
            save_config(export_trained_config(settings, net_spec, params, threshold), out)
        if not args.quiet:
            print(f"threshold {threshold:.4f}; wrote {out}")
        return 0

    # multi-pair: one DISTINCT net per channel, trained together
    # (train_ensemble)
    from syllable_detector_tpu_torch.training.trainer import train_ensemble

    mesh = _mesh("channel", device) if args.channel_parallel else None
    try:
        with timing.span("train.trainer"):
            net_spec, params_list, thresholds = train_ensemble(
                settings, feats_list, labels_list, mesh=mesh,
                verbose=not args.quiet,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                device=device,
            )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    with timing.span("train.export"):
        for c, (params, threshold) in enumerate(zip(params_list, thresholds)):
            out = _channel_output_path(args.output, c)
            save_config(export_trained_config(settings, net_spec, params, threshold), out)
            if not args.quiet:
                print(f"channel {c}: threshold {threshold:.4f}; wrote {out}")
    return 0


def _channel_output_path(template: str, channel: int) -> str:
    """`{ch}` placeholder, or `_<ch>` inserted before the extension."""
    if "{ch}" in template:
        return template.replace("{ch}", str(channel))
    root, ext = os.path.splitext(template)
    return f"{root}_{channel}{ext}"


if __name__ == "__main__":
    sys.exit(main())
