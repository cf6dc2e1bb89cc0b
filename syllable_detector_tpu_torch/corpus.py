"""Batched offline corpus scan on PyTorch: many files, one device computation.

Counterpart of ``syllable_detector_tpu.corpus``. The reference CLI iterates
files one after another, one detector per track. The batched scan pads
every (file, channel) stream to a shared bucket length, stacks them on a
lane axis and runs the whole corpus through one detection call: with
``method='fused'`` one launch of the fused detector kernel over all lanes
(shared or per-lane nets), otherwise the unfused path over every lane.
Per-file sample accounting and debounce reproduce ``TrackDetector``'s.
Files whose rate differs from the net's are resampled per channel by the
polyphase resampler (the framed GEMM kernel on a card).

Every entry takes a ``device``; it defaults to ``cuda``. With a ``mesh``
(``parallel.make_mesh``) the lane axis is split across the mesh's shards,
each on its own device and stream.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu_torch.kernels.fused_detector import fused_batch_offline_outputs
from syllable_detector_tpu_torch.models.detector import (
    DetectorSpec,
    detector_spec_from_config,
    offline_outputs_batch,
)
from syllable_detector_tpu_torch.ops.resample import polyphase_resample
from syllable_detector_tpu_torch.ops.stft import num_frames
from syllable_detector_tpu_torch.runtime.track_detector import _detection_lines
from syllable_detector_tpu_torch.utils import timing
from syllable_detector_tpu_torch.utils.wav import read_audio

__all__ = [
    "batch_offline_outputs_shared",
    "sharded_batch_offline_outputs_shared",
    "scan_corpus",
    "corpus_csv_lines",
    "scan_corpus_files",
    "resample_channels",
]


def batch_offline_outputs_shared(
    spec: DetectorSpec, params, xs: torch.Tensor, method: str = "matmul"
) -> torch.Tensor:
    """[C, n] streams -> [C, E, outputs] on ``xs``'s device.

    ``params`` is ONE shared network (dict) or a sequence of C DISTINCT
    per-lane networks sharing the spec's geometry. ``method='fused'`` runs
    the fused detector kernel (one launch for all lanes); 'matmul'/'rfft'
    run the unfused pipeline over every lane.
    """
    if method == "fused":
        return fused_batch_offline_outputs(spec, params, xs)
    return offline_outputs_batch(spec, params, xs, method)


def sharded_batch_offline_outputs_shared(
    mesh, spec: DetectorSpec, params, xs: torch.Tensor, method: str = "matmul"
) -> torch.Tensor:
    """[C, n] streams split over the mesh's shards -> [C, E, outputs] on
    shard 0's device. ``params``: one shared net (used by every shard) or C
    distinct per-lane nets (split with their lanes). C must divide by the
    mesh size (scan_corpus pads). Lanes never communicate."""
    from syllable_detector_tpu_torch.models.neural_net import stack_params
    from syllable_detector_tpu_torch.parallel.mesh import (
        sharded_fused_offline_outputs,
        sharded_offline_outputs,
    )

    if method == "fused":
        return sharded_fused_offline_outputs(mesh, spec, params, xs)
    plist = list(params) if isinstance(params, (list, tuple)) else [params] * xs.shape[0]
    return sharded_offline_outputs(mesh, spec, stack_params(plist), xs, method=method)


# bounded LRU so long-lived callers don't accumulate specs for dead configs
_spec_memo: OrderedDict = OrderedDict()
_SPEC_MEMO_MAX = 16


def _spec_cache(cfg: SyllableDetectorConfig, device):
    """Reuse (spec, params on ``device``) across calls for the same config
    object (holds a strong cfg reference so the id cannot be recycled)."""
    key = (id(cfg), str(device))
    hit = _spec_memo.get(key)
    if hit is None or hit[2] is not cfg:
        spec, params = detector_spec_from_config(cfg, device)
        _spec_memo[key] = (spec, params, cfg)
        while len(_spec_memo) > _SPEC_MEMO_MAX:
            _spec_memo.popitem(last=False)
        hit = _spec_memo[key]
    else:
        _spec_memo.move_to_end(key)
    return hit[0], hit[1]


def _bucket(n: int) -> int:
    """Round a stream length up to a power of two (at least 2**14)."""
    b = 1 << 14
    while b < n:
        b <<= 1
    return b


def scan_corpus(
    cfg: SyllableDetectorConfig,
    streams: Sequence[np.ndarray],
    method: str = "matmul",
    mesh=None,
    lane_configs: Optional[Sequence[SyllableDetectorConfig]] = None,
    device="cuda",
) -> list[np.ndarray]:
    """Detect over many same-rate streams at once -> per-stream [E_i, outputs].

    Streams are zero-padded to a common bucket and batched; each result is
    trimmed back to the stream's true evaluation count. Zero padding cannot
    create detections by itself, but an eval window straddling the end of a
    short stream sees padded zeros exactly as the reference sees silence.
    With ``mesh``, the lane axis is split across the mesh's shards (lanes
    padded to a multiple of the mesh size); the batch is placed on
    ``device`` and each shard takes its lanes from there.

    ``lane_configs`` gives each stream its own DISTINCT network, one config
    per stream, all sharing ``cfg``'s pipeline geometry (thresholds may
    differ; they are applied later per lane).
    """
    device = torch.device(device)
    spec, params = _spec_cache(cfg, device)
    if not streams:
        return []
    if lane_configs is not None:
        if len(lane_configs) != len(streams):
            raise ValueError(
                f"{len(lane_configs)} lane networks for {len(streams)} streams"
            )
        base = dataclasses.replace(spec, thresholds=())
        params = []
        for c in lane_configs:
            s_i, p_i = _spec_cache(c, device)
            if dataclasses.replace(s_i, thresholds=()) != base:
                raise ValueError(
                    "per-lane networks must share the first network's "
                    "geometry (sampling rate, FFT/window, band, layer sizes)"
                )
            params.append(p_i)
    streams = [np.asarray(s, np.float32).reshape(-1) for s in streams]
    lanes = len(streams)
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))
        lanes = -(-lanes // n_dev) * n_dev
        if lane_configs is not None:
            # padding lanes reuse net 0 (their outputs are sliced away)
            params = params + [params[0]] * (lanes - len(streams))
    bucket = _bucket(max(len(s) for s in streams))
    with timing.span("corpus.stage", lanes=lanes, samples=sum(map(len, streams)),
                     staged_samples=lanes * bucket):
        xs = np.zeros((lanes, bucket), np.float32)
        for i, s in enumerate(streams):
            xs[i, : len(s)] = s
    with timing.span("corpus.copy_in"):
        xd = torch.from_numpy(xs).to(device)
    with timing.span("corpus.detect"):
        if mesh is not None:
            outs = sharded_batch_offline_outputs_shared(mesh, spec, params, xd, method)
        else:
            outs = batch_offline_outputs_shared(spec, params, xd, method)
    with timing.span("corpus.readback"):  # the host waits here for the launch
        outs = outs.cpu().numpy()
    results = []
    for i, s in enumerate(streams):
        f = num_frames(len(s), cfg.window_length, cfg.window_overlap)
        results.append(outs[i, : max(0, f - cfg.time_range + 1)])
    return results


def corpus_csv_lines(
    cfg: SyllableDetectorConfig,
    outputs: np.ndarray,
    channel: int = 0,
    debounce_frames: int = 0,
) -> list[str]:
    """CSV detection lines from batched outputs, with the streaming
    TrackDetector's accounting byte for byte."""
    with timing.span("corpus.csv", rows=len(outputs)) as s:
        lines, _, hits = _detection_lines(
            cfg, outputs, channel, cfg.first_output_sample, debounce_frames, -1
        )
        s.counts["hits"] = hits
        s.counts["lines"] = len(lines)
    return lines


def scan_corpus_files(
    cfg: SyllableDetectorConfig,
    paths: Sequence[str],
    debounce_seconds: Optional[float] = None,
    emit=print,
    err=None,
    method: str = "matmul",
    headers: Optional[bool] = None,
    mesh=None,
    resample: bool = True,
    group_files: Optional[int] = None,
    device="cuda",
) -> None:
    """File-level corpus scan with the CLI's multi-file output contract.
    ``headers`` forces (or suppresses) per-file path header lines; None =
    the CLI default, emit them only when scanning more than one file.

    Every channel of every file becomes one lane of the batch. Within a
    file, detection lines are emitted grouped by channel in channel order —
    identical to sequential mode for files shorter than its chunk size.

    ``group_files`` bounds memory on huge corpora: files are scanned in
    groups of that many (output order and the CSV contract unchanged —
    file-major), so one long file no longer forces every lane to its
    padded bucket length and the whole corpus never sits in memory at once.

    ``cfg`` may be a sequence of configs: channel c of every file then uses
    network ``cfgs[c % len(cfgs)]`` (cycled); all nets must share the first
    network's pipeline geometry.
    """
    with timing.span("corpus.scan"):
        cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg]
        cfg = cfgs[0]
        err = err if err is not None else (lambda s: print(s, file=sys.stderr))
        if group_files and len(paths) > group_files:
            forced = len(paths) > 1 if headers is None else headers
            for i in range(0, len(paths), group_files):
                scan_corpus_files(
                    cfgs, paths[i : i + group_files],
                    debounce_seconds=debounce_seconds, emit=emit, err=err,
                    method=method, mesh=mesh, headers=forced, resample=resample,
                    device=device,
                )
            return
        streams = []  # one entry per (file, channel) lane
        lanes = []  # (path index, channel)
        good_paths = []
        for p in paths:
            try:
                with timing.span("corpus.read"):
                    samples, rate = read_audio(p)
            except (OSError, ValueError) as e:
                err(f"Unable to read {p}: {e}")
                continue
            if rate != cfg.sampling_rate and not resample:
                # the sequential path's --no-resample contract: warn and process
                # at the network rate
                err(
                    f"Warning: {p} is {rate} Hz but the network expects "
                    f"{cfg.sampling_rate} Hz (resampling disabled)."
                )
            elif rate != cfg.sampling_rate:
                err(f"Resampling {p} from {rate} Hz to {cfg.sampling_rate} Hz.")
                samples = resample_channels(samples, rate, cfg.sampling_rate, device)
            good_paths.append(p)
            for c in range(samples.shape[1]):
                streams.append(np.ascontiguousarray(samples[:, c]))
                lanes.append((len(good_paths) - 1, c))
        if not streams:
            return
        lane_cfgs = [cfgs[c % len(cfgs)] for _, c in lanes] if len(cfgs) > 1 else None
        results = scan_corpus(
            cfg, streams, method=method, mesh=mesh, lane_configs=lane_cfgs, device=device
        )
        debounce = int((debounce_seconds or 0.0) * cfg.sampling_rate)
        multiple = len(good_paths) > 1 if headers is None else headers
        by_file: dict[int, list] = {}
        for (pi, c), outs in zip(lanes, results):
            by_file.setdefault(pi, []).append((c, outs))
        for i, p in enumerate(good_paths):
            if multiple:
                emit(p)
            for c, outs in by_file.get(i, ()):
                # per-lane thresholds: channel c's own network decides its lines
                for line in corpus_csv_lines(
                    cfgs[c % len(cfgs)], outs, channel=c, debounce_frames=debounce
                ):
                    emit(line)


def resample_channels(samples: np.ndarray, rate: float, net_rate: float, device) -> np.ndarray:
    """[n, channels] samples at ``rate`` -> [n', channels] float32 at
    ``net_rate``: each channel through the polyphase resampler on ``device``."""
    with timing.span("corpus.resample", channels=samples.shape[1]):
        return np.stack(
            [
                polyphase_resample(
                    np.ascontiguousarray(samples[:, c]), rate, net_rate, device=device
                ).cpu().numpy()
                for c in range(samples.shape[1])
            ],
            axis=1,
        )
