"""Launch-shape report: time the fused kernel at each frames per CTA on the
local card, beside the shape the kernel's rule takes.

Counterpart of ``syllable_detector_tpu.tuning``. The JAX package tunes the
TPU kernel's tile; the port's counterpart is the frames one CTA of the fp32
fused kernel transforms (``kernels/fused_detector.CTA_FRAMES``), which
:func:`~syllable_detector_tpu_torch.kernels.fused_detector.cta_choice`
takes by a rule from the launch alone. ``python -m
syllable_detector_tpu_torch tune -n net.txt`` times each candidate with
CUDA events on the single-stream kernel (``single``) or the batched kernel
with a shared net (``batched``) or one net per lane (``distinct``), and
prints, for each workload, the trials, the fastest and the rule's choice
for that launch. It writes nothing, and no launch reads what it measured.
Candidates whose CTA does not fit in shared memory are skipped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "Trial",
    "WORKLOADS",
    "geometry_key",
    "tune_cta_frames",
    "main",
]

WORKLOADS = ("single", "batched", "distinct")
# evaluations of the single-stream tune, as the JAX package's tune_single
SINGLE_EVALS = 1 << 15


def geometry_key(spec) -> str:
    """Stable fingerprint of everything that shapes the kernel launch (not
    the weights: two nets of one geometry share a tuning); the JAX
    package's string for the same net."""
    return "|".join(
        str(v)
        for v in (
            spec.window_length,
            spec.window_overlap,
            spec.fourier_length,
            spec.bins[0],
            spec.bins[1],
            spec.time_range,
            tuple(spec.net.layer_sizes),
            tuple(spec.net.transfers),
            spec.scaling,
        )
    )


@dataclass
class Trial:
    tile: int  # frames one CTA transforms
    windows_per_s: float
    ms: float  # device ms per launch


def _fits(spec, frames: int) -> str | None:
    """Why ``frames`` cannot be a CTA of the fp32 kernel at this geometry,
    in the layout the kernel takes there (``col_group_for``), or None when
    it can."""
    from syllable_detector_tpu_torch.kernels import fused_detector as fused

    if frames % 64 or frames < spec.time_range:
        return "not a multiple of 64 above timeRange - 1"
    width = max(w for _, w in spec.net.layer_sizes)
    if fused.col_group_for(spec, frames, width) is None:
        smem = fused.smem_bytes(spec, frames, width)
        return (f"needs {smem} bytes of shared memory, the card offers {fused.SMEM_LIMIT}, "
                "and another frames per CTA fits")
    return None


def _measure(spec, params, workload: str, lanes: int, n_evals: int, frames: int,
             device) -> float:
    """Device ms of one launch of the fp32 kernel at ``frames`` per CTA:
    the single-stream entry (K1a) for ``single``, the batched entry (K1e)
    for ``batched`` / ``distinct``, on seeded chirps."""
    from syllable_detector_tpu_torch.kernels import fused_detector as fused
    from syllable_detector_tpu_torch.ops.stft import normalize_overlap
    from syllable_detector_tpu_torch.utils.measure import event_ms, make_audio

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the tuner times the kernel on a card, not on {device}")
    gap, _ = normalize_overlap(spec.window_overlap)
    n = (n_evals + spec.time_range - 2) * spec.hop + gap + spec.window_length
    base = make_audio(n, rate=spec.sampling_rate)
    xs = torch.from_numpy(np.stack([np.roll(base, 13 * c) for c in range(lanes)])).to(device)
    folded = (
        fused.fold_constants_stacked(spec, params, device)
        if workload == "distinct"
        else fused.fold_constants(spec, params, device)
    )
    width = max(w for _, w in spec.net.layer_sizes)
    group = fused.col_group_for(spec, frames, width)
    return event_ms(lambda: fused._launch(spec, folded, xs, n_evals, frames=frames,
                                          col_group=group))[0]


def tune_cta_frames(
    spec,
    params,
    workload: str,
    lanes: int,
    n_evals: int,
    tiles: tuple | None = None,
    measure=None,
    log=None,
    device="cuda",
) -> tuple[list[Trial], int]:
    """Time the fp32 kernel at each candidate frames per CTA (default
    ``CTA_FRAMES``) for one workload (``single``: one stream, ``params`` one
    net; ``batched``: ``lanes`` lanes, one net; ``distinct``: ``params`` a
    list of ``lanes`` nets), skipping candidates that do not fit.
    ``measure(frames)`` replaces the timing (tests). Returns the trials,
    fastest first (empty when nothing fit), and the frames the kernel's rule
    takes for this launch on ``device``."""
    from syllable_detector_tpu_torch.kernels import fused_detector as fused

    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r} (one of {WORKLOADS})")
    if workload == "single":
        lanes = 1
    tiles = tuple(fused.CTA_FRAMES if tiles is None else tiles)
    trials = []
    for frames in tiles:
        why = _fits(spec, frames)
        if why:
            if log:
                log(f"frames {frames}: {why} — skipped")
            continue
        ms = (
            measure(frames)
            if measure is not None
            else _measure(spec, params, workload, lanes, n_evals, frames, device)
        )
        trials.append(Trial(tile=frames, windows_per_s=lanes * n_evals / (ms * 1e-3), ms=ms))
        if log:
            log(f"frames {frames}: {ms:.4f} ms, {trials[-1].windows_per_s:,.0f} windows/s")
    trials.sort(key=lambda t: t.ms)
    device = torch.device(device)
    n_sm = fused._sm_count(device) if device.type == "cuda" else fused.H100_SMS
    width = max(w for _, w in spec.net.layer_sizes)
    return trials, fused.cta_frames(spec, n_evals, lanes, width, n_sm)


def main(argv=None) -> int:
    import argparse
    import sys

    from syllable_detector_tpu_torch.config.model_format import load_config
    from syllable_detector_tpu_torch.models.detector import detector_spec_from_config
    from syllable_detector_tpu_torch.utils.measure import perturbed_params

    p = argparse.ArgumentParser(
        prog="syllable_detector_tpu_torch tune",
        description="Time the fused kernel's frames per CTA on the local card "
        "and report the fastest beside the kernel's own choice (writes nothing).",
    )
    p.add_argument("-n", "--network", required=True, help="network text file")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--n-evals", type=int, default=2048,
                   help="evaluations per channel per call")
    p.add_argument("--tiles", type=int, nargs="+", default=None,
                   help="frames per CTA to try (default: the kernel's CTA_FRAMES)")
    p.add_argument("--workload", choices=[*WORKLOADS, "all"], default="batched")
    p.add_argument("--distinct-seed", type=int, default=1)
    p.add_argument("--device", default="cuda", help="Torch device to time on (default: cuda).")
    args = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was requested but no CUDA device is available")
    spec, params = detector_spec_from_config(load_config(args.network), device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    log(f"device {name}; geometry {geometry_key(spec)}")

    runs = []
    if args.workload in ("batched", "all"):
        runs.append(("batched", params, args.channels, args.n_evals))
    if args.workload in ("distinct", "all"):
        nets = [perturbed_params(params, args.distinct_seed + i) for i in range(args.channels)]
        runs.append(("distinct", nets, args.channels, args.n_evals))
    if args.workload in ("single", "all"):
        runs.append(("single", params, 1, SINGLE_EVALS))
    rows = []
    for workload, nets, lanes, n_evals in runs:
        log(f"-- {workload}, {lanes} lane(s) x {n_evals} evaluations")
        trials, rule = tune_cta_frames(spec, nets, workload, lanes, n_evals, tiles=args.tiles,
                                       log=log, device=device)
        if trials:
            rows.append((workload, lanes, n_evals, trials, rule))

    if not rows:
        log("error: no candidate fits the kernel at this geometry (frames per CTA "
            "must be a multiple of 64 above timeRange - 1 within the shared "
            "memory)")
        return 1
    for workload, lanes, n_evals, trials, rule in rows:
        t = trials[0]
        timed = ", ".join(f"frames {u.tile} {u.ms:.4f} ms"
                          for u in sorted(trials, key=lambda u: u.tile))
        print(f"{workload}: frames {t.tile} {t.ms:.4f} ms {t.windows_per_s:,.0f} windows/s; "
              f"rule {rule}; {lanes} x {n_evals}: {timed}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
