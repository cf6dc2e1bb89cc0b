"""Batched offline corpus scan on PyTorch: many files, one device computation.

Counterpart of ``syllable_detector_tpu.corpus``. The reference CLI iterates
files one after another, one detector per track. The batched scan stacks
every (file, channel) stream on a lane axis, as long as the longest stream
(rounded up to 4 samples) with zeros past each shorter one, and runs the
whole corpus through one detection call: with ``method='fused'`` one launch
of the fused detector kernel over all lanes (shared or per-lane nets),
otherwise the unfused path over every lane. Per-file sample accounting and
debounce reproduce ``TrackDetector``'s.

Samples cross to the device once. Each file lands in a room of one reused
host buffer a device, used as a ring (page-locked on a card), and is
uploaded from there asynchronously: a 16-bit PCM WAV's codes read straight
in and scaled to float32 on the device, any other file decoded on the host
and its float32 block copied in. Files whose rate differs from the net's are resampled per
channel on the device by the polyphase resampler (the framed GEMM kernel on
a card), and the lanes are written into the batch there.

Every entry takes a ``device``; it defaults to ``cuda``. With a ``mesh``
(``parallel.make_mesh``) the lane axis is split across the mesh's shards,
each on its own device and stream.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
from collections import OrderedDict
from time import perf_counter_ns
from typing import Optional, Sequence

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu_torch.kernels.fused_detector import (
    FusedOperands,
    fold_constants,
    fusable,
    fused_batch_offline_outputs,
)
from syllable_detector_tpu_torch.models.detector import (
    DetectorSpec,
    detector_spec_from_config,
    offline_outputs_batch,
)
from syllable_detector_tpu_torch.ops.resample import polyphase_resample
from syllable_detector_tpu_torch.ops.stft import num_frames
from syllable_detector_tpu_torch.runtime.track_detector import _detection_lines
from syllable_detector_tpu_torch.utils import timing
from syllable_detector_tpu_torch.utils.wav import _read_pcm16_into, read_audio

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
    run the unfused pipeline over every lane. A shared net that the scan's
    spec cache holds is folded into the kernel's operands once, not per
    call.
    """
    if method == "fused":
        folded = _cached_fold(spec, params, xs.device)
        return fused_batch_offline_outputs(spec, params, xs, folded=folded)
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
        _spec_memo[key] = [spec, params, cfg, None]  # the fold, at its first use
        while len(_spec_memo) > _SPEC_MEMO_MAX:
            _spec_memo.popitem(last=False)
        hit = _spec_memo[key]
    else:
        _spec_memo.move_to_end(key)
    return hit[0], hit[1]


def _cached_fold(spec: DetectorSpec, params, device: torch.device) -> Optional[FusedOperands]:
    """The fused kernel's operands on ``device`` of a shared net that
    :func:`_spec_cache` holds there, folded at its first use and kept beside
    it (a fold reads the net back from the device); None for any other net,
    which the kernel's entry folds per call."""
    if not fusable(spec):
        return None
    for hit in _spec_memo.values():
        if hit[1] is params and params["layers"][0]["w"].device == device:
            if hit[3] is None:
                hit[3] = fold_constants(spec, params, device)
            return hit[3]
    return None


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; a card with its index, as the
    device of a tensor on it reads."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _batch_length(n: int) -> int:
    """The batch's lane length for a longest stream of ``n`` samples: ``n``
    rounded up to 4, so that every lane's row starts on 16 bytes, where the
    fused kernel reads its samples 16 bytes at a time."""
    return -(-n // 4) * 4


_ALIGN = 64  # bytes: where each room of a host ring starts
_FILE_ROOMS = 3  # rooms of the largest file a host ring holds


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


class _HostRing:
    """A device's reused host buffer of bytes (page-locked on a card), handed
    out as a ring of rooms, one for each upload: a room starts after the one
    before, or at the buffer's start where it does not fit there, and waits
    only for the uploads out of the rooms it overlaps (the events recorded
    by :meth:`uploaded`; a CPU's copies are done when they return). Hold
    ``lock`` from a room's taking to its upload."""

    def __init__(self):
        self.lock = threading.RLock()
        self.buf = torch.empty(0, dtype=torch.uint8)
        self.head = 0
        self.live: list[tuple[int, int, torch.cuda.Event]] = []  # oldest first

    def reserve(self, device: torch.device, nbytes: int) -> None:
        """Grow the buffer to hold :data:`_FILE_ROOMS` rooms of ``nbytes``,
        once every upload out of it has finished. Three rooms of a scan's
        largest file keep each file's room off the room of the file before:
        no file's read waits on the upload of the file before it."""
        need = _FILE_ROOMS * _aligned(nbytes)
        with self.lock:
            if self.buf.numel() < need:
                self._wait(0, self.buf.numel())
                self.buf = torch.empty(need, dtype=torch.uint8,
                                       pin_memory=device.type == "cuda")
                self.head = 0

    def room(self, device: torch.device, nbytes: int) -> torch.Tensor:
        """``nbytes`` bytes of the buffer, grown by :meth:`reserve` to hold
        this room where it does not."""
        size = _aligned(nbytes)
        self.reserve(device, nbytes)
        if self.head + size > self.buf.numel():
            self.head = 0
        at, self.head = self.head, self.head + size
        self._wait(at, self.head)
        return self.buf[at : at + nbytes]

    def uploaded(self, device: torch.device, room: torch.Tensor) -> None:
        """Record, on a card, the event after the uploads enqueued out of
        ``room``, on which a later room over it waits."""
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            at = room.data_ptr() - self.buf.data_ptr()
            self.live.append((at, at + room.numel(), done))

    def _wait(self, lo: int, hi: int) -> None:
        while self.live and self.live[0][2].query():  # finished, oldest first
            self.live.pop(0)
        for at, end, done in self.live:
            if at < hi and lo < end:
                done.synchronize()
        self.live = [r for r in self.live if not (r[0] < hi and lo < r[1])]


_host_buffers: dict[str, _HostRing] = {}  # one a device


def _host_ring(device: torch.device) -> _HostRing:
    return _host_buffers.setdefault(str(device), _HostRing())


def _stage(samples: np.ndarray, device: torch.device,
           room: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A float32 host array on ``device``: copied into ``room`` of the
    device's host ring where it fits there, else into a room of its own, and
    uploaded from there once (on a card asynchronously; on a CPU as a copy,
    since the ring is refilled)."""
    ring = _host_ring(device)
    with ring.lock:
        with timing.span("corpus.stage", lanes=samples.shape[1] if samples.ndim == 2 else 1,
                         samples=samples.size, staged_samples=samples.size):
            if room is None or samples.nbytes > room.numel():
                room = ring.room(device, samples.nbytes)
            host = room[: samples.nbytes].view(torch.float32).view(samples.shape)
            np.copyto(host.numpy(), samples)
        with timing.span("corpus.copy_in"):
            out = host.to(device, non_blocking=True) if device.type == "cuda" else host.clone()
            ring.uploaded(device, room)
    return out


def _file_size(path) -> int:
    try:
        return os.stat(path).st_size
    except OSError:
        return 0  # the read reports it


def _file_to_device(path: str, device: torch.device, size: int) -> tuple[torch.Tensor, int]:
    """A file's ``[n, channels]`` samples as float32 on ``device``, and its
    rate: read into a room of the device's host ring, uploaded once.

    The room, of ``size``, the file's size on disk, is taken before the
    read, so that its wait is the stage's and not the read's. A 16-bit PCM
    WAV's codes are read straight into it (:func:`_read_pcm16_into`),
    uploaded as int16 and scaled by 2**-15 on the device: every int16 and
    its product are exact in float32, so the samples equal
    :func:`read_audio`'s bit for bit. Any other file is decoded by
    :func:`read_audio` and its float32 block copied into the room, or into
    a larger one. Raises what the read raises."""
    ring = _host_ring(device)
    with ring.lock:
        t0 = perf_counter_ns()
        room = ring.room(device, size)
        waited = (t0, perf_counter_ns())
        with timing.span("corpus.read", direct=0) as read:
            direct = _read_pcm16_into(path, room.numpy())
            if direct is None:
                samples, rate = read_audio(path)
            else:
                read.counts["direct"] = 1
        if direct is not None:
            nbytes, channels, rate = direct
            n = nbytes // (2 * channels)
            timing.record("corpus.stage", *waited, lanes=channels, samples=n * channels,
                          staged_samples=n * channels)
            with timing.span("corpus.copy_in"):
                codes = room[:nbytes].view(torch.int16).view(n, channels)
                if device.type == "cuda":
                    codes = codes.to(device, non_blocking=True)
                ring.uploaded(device, room)
                return codes.to(torch.float32).mul_(2.0**-15), rate
        return _stage(np.asarray(samples, np.float32), device, room), rate


def scan_corpus(
    cfg: SyllableDetectorConfig,
    streams: Sequence[np.ndarray | torch.Tensor],
    method: str = "matmul",
    mesh=None,
    lane_configs: Optional[Sequence[SyllableDetectorConfig]] = None,
    device="cuda",
) -> list[np.ndarray]:
    """Detect over many same-rate streams at once -> per-stream [E_i, outputs].

    ``streams`` are numpy arrays or tensors. Each that is not a tensor on
    ``device`` is staged in the host buffer and uploaded once
    (:func:`_stage`). They are stacked on ``device`` as the lanes of one
    ``[lanes, L]`` float32 batch, ``L`` the longest stream rounded up to 4
    samples, with zeros past each shorter stream; each result is trimmed
    back to the stream's true evaluation count, so no evaluation kept reads
    past its stream, and the zeros keep the batch the same whatever the
    reused buffers held. With ``mesh``, the lane axis is split across the
    mesh's shards (lanes padded with zero lanes to a multiple of the mesh
    size); the batch is placed on ``device`` and each shard takes its lanes
    from there.

    ``lane_configs`` gives each stream its own DISTINCT network, one config
    per stream, all sharing ``cfg``'s pipeline geometry (thresholds may
    differ; they are applied later per lane).
    """
    device = _device(device)
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
    streams = [s.reshape(-1) if isinstance(s, torch.Tensor) and s.device == device
               else _stage(np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s,
                                      np.float32).reshape(-1), device)
               for s in streams]
    lanes = len(streams)
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))
        lanes = -(-lanes // n_dev) * n_dev
        if lane_configs is not None:
            # padding lanes reuse net 0 (their outputs are sliced away)
            params = params + [params[0]] * (lanes - len(streams))
    width = _batch_length(max(len(s) for s in streams))
    with timing.span("corpus.copy_in"):
        xd = torch.empty((lanes, width), dtype=torch.float32, device=device)
        for row, s in zip(xd, streams):
            row[: len(s)].copy_(s)
            row[len(s):].zero_()
        xd[len(streams):].zero_()
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

    Each file's samples cross to ``device`` once (:func:`_file_to_device`:
    the host buffer, one upload); resampling and the batch stay there.

    ``group_files`` bounds memory on huge corpora: files are scanned in
    groups of that many (output order and the CSV contract unchanged —
    file-major), so one long file no longer forces every lane to its
    length and the whole corpus never sits in memory at once.

    ``cfg`` may be a sequence of configs: channel c of every file then uses
    network ``cfgs[c % len(cfgs)]`` (cycled); all nets must share the first
    network's pipeline geometry.
    """
    device = _device(device)
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
        sizes = [_file_size(p) for p in paths]
        _host_ring(device).reserve(device, max(sizes, default=0))  # grown once
        for p, size in zip(paths, sizes):
            try:
                samples, rate = _file_to_device(p, device, size)
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
                streams.append(samples[:, c])
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


def resample_channels(
    samples: np.ndarray | torch.Tensor, rate: float, net_rate: float, device
) -> np.ndarray | torch.Tensor:
    """[n, channels] samples at ``rate`` -> [n', channels] float32 at
    ``net_rate``: each channel through the polyphase resampler on ``device``.
    A tensor gives a tensor on ``device``, with nothing copied to the host;
    numpy gives numpy."""
    with timing.span("corpus.resample", channels=samples.shape[1]):
        if isinstance(samples, torch.Tensor):
            channels = [samples[:, c] for c in range(samples.shape[1])]
        else:
            channels = [np.ascontiguousarray(samples[:, c]) for c in range(samples.shape[1])]
        out = torch.stack(
            [polyphase_resample(x, rate, net_rate, device=device) for x in channels], 1
        )
        return out if isinstance(samples, torch.Tensor) else out.cpu().numpy()
