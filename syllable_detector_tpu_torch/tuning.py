"""Auto-tuner: measure the fused kernel's launch shape on the local card and
cache the winner per (card, network geometry, workload, launch size).

Counterpart of ``syllable_detector_tpu.tuning``. The JAX package tunes the
TPU kernel's tile; the port's counterpart is the frames one CTA of the fp32
fused kernel transforms (``kernels/fused_detector.CTA_FRAMES``), which
:func:`~syllable_detector_tpu_torch.kernels.fused_detector.cta_frames`
otherwise chooses analytically from the launch shape. ``python -m
syllable_detector_tpu_torch tune -n net.txt`` times each candidate with
CUDA events on the single-stream kernel (``single``) or the batched kernel
with a shared net (``batched``) or one net per lane (``distinct``), and
writes the fastest to a JSON cache that ``cta_frames`` consults before its
analytic choice (full fp32, samples input). Candidates whose CTA does not
fit in shared memory are skipped.

Cache: ``~/.cache/syllable_detector_tpu_torch/tune.json`` (override with
``SD_TUNE_CACHE``), written atomically under a lock; a corrupt file reads
as empty. Keys are the kernel's revision (:data:`KERNEL_REVISION`), the
card (``cuda:`` and its name), the geometry, the workload, and lanes and
evaluations bucketed to powers of two, so one tune covers a deployment's
neighbourhood, and a tune of an older kernel is not consulted.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "Trial",
    "WORKLOADS",
    "KERNEL_REVISION",
    "geometry_key",
    "tune_cache_path",
    "reset_tune_cache",
    "device_kind",
    "tune_key",
    "tuned_cta_frames",
    "tune_cta_frames",
    "main",
]

WORKLOADS = ("single", "batched", "distinct")
# The fused kernel's revision in the cache's keys: bumped whenever a change
# to the kernel's layouts or arithmetic can move which frames per CTA win,
# so that what an older kernel measured is not taken for this one's.
KERNEL_REVISION = 3
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


def tune_cache_path() -> str:
    return os.environ.get(
        "SD_TUNE_CACHE",
        os.path.expanduser("~/.cache/syllable_detector_tpu_torch/tune.json"),
    )


_cache_mem: dict | None = None
_cache_mem_path: str | None = None
# tuned_cta_frames' answers by (the cache's path settings, card, spec,
# workload, lane bucket, evaluation bucket): every fp32 launch consults it,
# so after the first launch of a shape the consult is one dict lookup
_answers: dict = {}


def _load_cache() -> dict:
    """The cache, read once per path (every launch consults it)."""
    global _cache_mem, _cache_mem_path
    path = tune_cache_path()
    if _cache_mem is not None and _cache_mem_path == path:
        return _cache_mem
    try:
        with open(path) as fh:
            cache = json.load(fh)
    except (OSError, ValueError):
        cache = {}
    _cache_mem = cache if isinstance(cache, dict) else {}
    _cache_mem_path = path
    return _cache_mem


def reset_tune_cache() -> None:
    """Drop the in-process copy (after an external edit of the file)."""
    global _cache_mem, _cache_mem_path
    _cache_mem = None
    _cache_mem_path = None
    _answers.clear()


def _save_entry(key: str, entry: dict) -> None:
    """Read, update and atomically replace the cache file under an
    exclusive lock, so concurrent tunes keep each other's entries."""
    import fcntl

    path = tune_cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            with open(path) as fh:
                cache = json.load(fh)
        except (OSError, ValueError):
            cache = {}
        if not isinstance(cache, dict):
            cache = {}
        cache[key] = entry
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(cache, fh, indent=1)
        os.replace(tmp, path)
    reset_tune_cache()


def device_kind(device) -> str:
    """The cache's name for a device: ``cuda:`` and the card's name."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return f"cuda:{torch.cuda.get_device_name(device)}"


def _bucket(n: int) -> int:
    """Next power of two (>= 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


def tune_key(kind: str, spec, workload: str, lanes: int, n_evals: int) -> str:
    return "/".join(
        (f"r{KERNEL_REVISION}", kind, geometry_key(spec), workload, f"c{_bucket(lanes)}",
         f"ne{_bucket(n_evals)}")
    )


def tuned_cta_frames(kind: str, spec, workload: str, lanes: int, n_evals: int) -> int | None:
    """The cached winning frames per CTA for this card, geometry, workload
    and launch size, or None. The caller checks that it fits."""
    memo = (os.environ.get("SD_TUNE_CACHE"), os.environ.get("HOME"), kind, spec, workload,
            _bucket(lanes), _bucket(n_evals))
    if memo in _answers:
        return _answers[memo]
    entry = _load_cache().get(tune_key(kind, spec, workload, lanes, n_evals))
    frames = None
    if isinstance(entry, dict):
        try:
            frames = int(entry["frames"])
        except (KeyError, TypeError, ValueError):
            pass
    _answers[memo] = frames
    return frames


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
) -> list[Trial]:
    """Time the fp32 kernel at each candidate frames per CTA (default
    ``CTA_FRAMES``) for one workload (``single``: one stream, ``params`` one
    net; ``batched``: ``lanes`` lanes, one net; ``distinct``: ``params`` a
    list of ``lanes`` nets), skipping candidates that do not fit, and
    persist the fastest for :func:`tuned_cta_frames`. ``measure(frames)``
    replaces the timing (tests). Returns the trials, fastest first (empty
    when nothing fit)."""
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
    if trials:
        width = max(w for _, w in spec.net.layer_sizes)
        _save_entry(
            tune_key(device_kind(device), spec, workload, lanes, n_evals),
            {
                "frames": trials[0].tile,
                "ms": trials[0].ms,
                "windows_per_s": trials[0].windows_per_s,
                "analytic": fused.cta_frames(spec, n_evals, lanes, width),
                "trials": [[t.tile, t.ms] for t in trials],
            },
        )
    return trials


def main(argv=None) -> int:
    import argparse
    import sys

    from syllable_detector_tpu_torch.config.model_format import load_config
    from syllable_detector_tpu_torch.models.detector import detector_spec_from_config
    from syllable_detector_tpu_torch.utils.measure import perturbed_params

    p = argparse.ArgumentParser(
        prog="syllable_detector_tpu_torch tune",
        description="Time the fused kernel's frames per CTA on the local card "
        "and cache the winners (consulted by every launch).",
    )
    p.add_argument("-n", "--network", required=True, help="network text file")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--n-evals", type=int, default=2048,
                   help="evaluations per channel per call")
    p.add_argument("--tiles", type=int, nargs="+", default=None,
                   help="frames per CTA to try (default: the kernel's CTA_FRAMES)")
    p.add_argument("--workload", choices=[*WORKLOADS, "all"], default="batched")
    p.add_argument("--distinct-seed", type=int, default=1)
    p.add_argument("--device", default="cuda", help="Torch device to tune (default: cuda).")
    args = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was requested but no CUDA device is available")
    spec, params = detector_spec_from_config(load_config(args.network), device)
    log(f"device {device_kind(device)}; cache {tune_cache_path()}")

    runs = []
    if args.workload in ("batched", "all"):
        runs.append(("batched", params, args.channels, args.n_evals))
    if args.workload in ("distinct", "all"):
        nets = [perturbed_params(params, args.distinct_seed + i) for i in range(args.channels)]
        runs.append(("distinct", nets, args.channels, args.n_evals))
    if args.workload in ("single", "all"):
        runs.append(("single", params, 1, SINGLE_EVALS))
    rows = []
    for name, nets, lanes, n_evals in runs:
        log(f"-- {name}, {lanes} lane(s) x {n_evals} evaluations")
        trials = tune_cta_frames(spec, nets, name, lanes, n_evals, tiles=args.tiles,
                                 log=log, device=device)
        rows += [(name, t) for t in trials[:1]]

    if not rows:
        log("error: no candidate fits the kernel at this geometry (frames per CTA "
            "must be a multiple of 64 above timeRange - 1 within the shared "
            "memory); nothing was cached")
        return 1
    for name, t in rows:
        print(f"{name}: frames {t.tile} {t.ms:.4f} ms {t.windows_per_s:,.0f} windows/s")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
