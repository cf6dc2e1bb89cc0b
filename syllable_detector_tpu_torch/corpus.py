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
and its float32 block copied in. A scan reads its files a few ahead of the
calling thread, each into a room of its own, and the calling thread uploads
them in file order: a 16-bit file's data chunk in pieces, taken in file
order by native threads that never hold the interpreter lock (so the first
file lands first, and the calling thread's work on it runs at full speed
while later pieces are read), any other file on a small pool of Python
threads. Files whose rate differs from the
net's are resampled per channel on the device by the polyphase resampler (the framed GEMM kernel on
a card), and the lanes are written into the batch there.

Every entry takes a ``device``; it defaults to ``cuda``. With a ``mesh``
(``parallel.make_mesh``) the lane axis is split across the mesh's shards,
each on its own device and stream.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import hashlib
import itertools
import os
import sys
import threading
from collections import OrderedDict
from concurrent import futures
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
from syllable_detector_tpu_torch.utils.native_build import (
    NATIVE_BUILD,
    NATIVE_SRC,
    NativeBuildError,
    ensure_native_library,
)
from syllable_detector_tpu_torch.utils.wav import _pcm16_layout, _read_range_into, read_audio

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
# the most threads a scan reads its files on and the most files it reads
# ahead, which also bounds its pinned ring at 10 rooms of its largest file:
# on an 8-CPU H100 host, 6 and 8 threads read the benchmark's corpus cell
# (8 files) fastest of 1, 2, 3, 4, 6 and 8 (PERF.md)
_READ_CAP = 8
# the bytes of a 16-bit file's data chunk that one piece reads: on an 8-CPU
# H100 host, 1, 2 and 8 MiB read the benchmark's corpus cell fastest of 1, 2,
# 4 and 8 MiB, within their spread, and 2 MiB pieces 1.18 times as fast as
# whole files (PERF.md)
_PIECE = 2 << 20


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _ring_bytes(sizes: Sequence[int], workers: int) -> int:
    """The bytes of a host ring for rooms of ``sizes``, taken up to
    ``workers`` reads ahead of their uploads. Rooms taken and not yet
    uploaded are at most ``workers + 1`` (the reads in flight and a decoded
    file's larger room), each at most the largest, and a room that does not
    fit before the buffer's end leaves less than the largest unused there:
    so ``workers + 2`` rooms of the largest, or every room once and the
    largest, whichever is less, keep each room off every room still
    taken."""
    if not sizes:
        return 0
    largest = _aligned(max(sizes))
    return min((workers + 2) * largest, sum(map(_aligned, sizes)) + largest)


class _HostRing:
    """A device's reused host buffer of bytes (page-locked on a card), handed
    out as a ring of rooms, one for each upload: a room starts after the one
    before, or at the buffer's start where it does not fit there. A room
    waits only for the uploads out of the rooms it overlaps (the events
    recorded by :meth:`uploaded`; a CPU's copies are done when they return)
    and never overlaps a room taken and not yet uploaded or released: where
    it would, the ring moves to a larger buffer, and the rooms taken in the
    old one keep its memory. ``lock`` guards the ring's state, never a
    read."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buf = torch.empty(0, dtype=torch.uint8)
        self.head = 0
        self.taken: list[tuple[int, int]] = []  # rooms neither uploaded nor released
        self.live: list[tuple[int, int, torch.cuda.Event]] = []  # uploads, oldest first

    def reserve(self, device: torch.device, nbytes: int) -> None:
        """Grow the buffer to ``nbytes`` where it is smaller (a scan's
        :func:`_ring_bytes`, so that its rooms fit in one buffer)."""
        with self.lock:
            if self.buf.numel() < nbytes:
                self._grow(device, nbytes)

    def room(self, device: torch.device, nbytes: int) -> torch.Tensor:
        """``nbytes`` bytes of the buffer, taken until :meth:`uploaded` or
        :meth:`release` hands them back."""
        size = _aligned(nbytes)
        with self.lock:
            at = self.head if self.head + size <= self.buf.numel() else 0
            if at + size > self.buf.numel() or any(
                    a < at + size and at < b for a, b in self.taken):
                self._grow(device, 2 * max(self.buf.numel(), size))
                at = 0
            self.head = at + size
            self._wait(at, self.head)
            self.taken.append((at, self.head))
            return self.buf[at : at + nbytes]

    def uploaded(self, device: torch.device, room: torch.Tensor) -> None:
        """Hand ``room`` back once its uploads are enqueued, recording on a
        card the event after them, on which a later room over it waits."""
        with self.lock:
            span = self._give_back(room)
            if span is not None and device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
                self.live.append((*span, done))

    def release(self, room: torch.Tensor) -> None:
        """Hand ``room`` back with nothing uploaded out of it."""
        with self.lock:
            self._give_back(room)

    def _give_back(self, room: torch.Tensor) -> Optional[tuple[int, int]]:
        if room.untyped_storage().data_ptr() != self.buf.untyped_storage().data_ptr():
            return None  # a room of a buffer the ring has left
        at = room.storage_offset()  # an empty room's data_ptr() reads 0
        span = (at, at + _aligned(room.numel()))
        self.taken.remove(span)
        return span

    def _grow(self, device: torch.device, nbytes: int) -> None:
        self._wait(0, self.buf.numel())
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.head, self.taken = 0, []

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
    device's host ring where it fits there, else into a room of its own
    (``room`` handed back), and uploaded from there once (on a card
    asynchronously; on a CPU as a copy, since the ring is refilled)."""
    ring = _host_ring(device)
    with timing.span("corpus.stage", lanes=samples.shape[1] if samples.ndim == 2 else 1,
                     samples=samples.size, staged_samples=samples.size):
        if room is None or samples.nbytes > room.numel():
            if room is not None:
                ring.release(room)
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


def _cpus() -> int:
    """The CPUs this process may run on."""
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1


def _read_workers(files: int) -> int:
    """The files a scan of ``files`` files reads ahead, and the threads it
    reads on: one a file, at most one a CPU, at most :data:`_READ_CAP`."""
    return max(1, min(files, _cpus(), _READ_CAP))


def _cut(length: int) -> list[int]:
    """The bounds of a data chunk of ``length`` bytes cut into pieces of
    :data:`_PIECE` bytes, the last the rest: 0, :data:`_PIECE`, ...,
    ``length``; a chunk shorter than two pieces is one."""
    if length < 2 * _PIECE:
        return [0, length]
    return [*range(0, length, _PIECE), length]


_pool: Optional[tuple[int, int, futures.ThreadPoolExecutor]] = None  # (pid, threads, pool)
_pool_lock = threading.Lock()


def _read_pool(workers: int) -> futures.ThreadPoolExecutor:
    """The process's pool of reading threads, made at its first use, of at
    least ``workers`` threads (a pool inherited across a fork has none)."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != os.getpid() or _pool[1] < workers:
            threads = max(workers, _READ_CAP)
            _pool = (os.getpid(), threads,
                     futures.ThreadPoolExecutor(threads, thread_name_prefix="corpus-read"))
        return _pool[2]


def _load_piece_reader() -> Optional[ctypes.CDLL]:
    """``native/piece_reader.cpp``, built at its first use under a name
    that carries its source's hash; None where it cannot be built or
    loaded."""
    src = os.path.join(NATIVE_SRC, "piece_reader.cpp")
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        lib = ctypes.CDLL(ensure_native_library(
            src, os.path.join(NATIVE_BUILD, f"libsdpieces-{digest}.so"),
            extra_flags=("-pthread",)))
    except (OSError, NativeBuildError):
        return None
    i32, i64, ptr, p64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    lib.sdpieces_pool.restype, lib.sdpieces_pool.argtypes = ptr, [i32]
    lib.sdpieces_read.restype, lib.sdpieces_read.argtypes = ptr, [ptr, i32, ptr, i64, p64, i32]
    lib.sdpieces_wait.restype, lib.sdpieces_wait.argtypes = i64, [ptr, ptr, p64]
    return lib


_pieces: Optional[tuple[int, Optional[ctypes.CDLL], Optional[int]]] = None  # (pid, library, pool)
_pieces_lock = threading.Lock()


def _piece_reader() -> Optional[tuple[ctypes.CDLL, int]]:
    """(the piece reader's library, the process's pool of its native
    threads), made at its first use with one thread a CPU but one, which
    the calling thread keeps for its own work while they read, at least 1
    and at most :data:`_READ_CAP` (a pool inherited across a fork has
    none); None where the library cannot be built or loaded."""
    global _pieces
    with _pieces_lock:
        if _pieces is None or _pieces[0] != os.getpid():
            lib = _load_piece_reader() if _pieces is None else _pieces[1]
            threads = max(1, min(_cpus() - 1, _READ_CAP))
            pool = lib.sdpieces_pool(threads) if lib is not None else None
            _pieces = (os.getpid(), lib, pool)
        return None if _pieces[1] is None else (_pieces[1], _pieces[2])


class _FileRead:
    """One file of a scan, from its room to its upload.

    On the calling thread, the room, of ``size``, the file's size on disk,
    is taken and the file's chunk headers walked (:func:`_pcm16_layout`),
    so that both are the stage's time and not the read's; then
    :meth:`hand_out` hands the read out, given a ``pool``: a 16-bit PCM
    WAV's data chunk to the piece reader (``native/piece_reader.cpp``) as
    the pieces of :func:`_cut`, each read with ``pread`` into its byte
    range of the room by threads that never take the interpreter lock,
    first in, first out; any other file, one that the walk refuses or
    cannot open, to ``pool`` as one decode. What is not handed out (no
    pool, or a 16-bit file where the piece reader cannot be built) is read
    inline by :meth:`to_device`.

    Once it has ended, ``times`` holds the read's start (its first
    piece's) and end (its last piece's), ``direct`` is 1 where the codes
    went straight in, and ``pieces`` counts the pieces it was cut into (1
    for a read in one piece): :func:`_record_reads` records them."""

    def __init__(self, path: str, device: torch.device, size: int):
        self.path, self.device = path, device
        t0 = perf_counter_ns()
        self.room = _host_ring(device).room(device, size)
        self.fh, self.layout = self._walk()
        self.waited = (t0, perf_counter_ns())
        self.job = self.task = self.times = None
        self.direct, self.pieces = 0, 1

    def _walk(self):
        """(the file open unbuffered, :func:`_pcm16_layout`) of a 16-bit
        PCM WAV whose codes fit the room; (None, None) for any other."""
        try:
            fh = open(self.path, "rb", buffering=0)
        except OSError:
            return None, None  # read_audio raises it at the file's turn
        try:
            layout = _pcm16_layout(fh, self.path, self.room.numel())
        except OSError:
            layout = None
        if layout is None:
            fh.close()
            return None, None
        return fh, layout

    def hand_out(self, pool: Optional[futures.ThreadPoolExecutor]) -> None:
        """Hand the read out: a 16-bit file's pieces to the piece reader,
        any other file's decode to ``pool``; with no pool, nothing."""
        if pool is None:
            return
        if self.layout is None:
            self.task = pool.submit(self._timed, read_audio, self.path)
            return
        reader = _piece_reader()
        if reader is not None:
            lib, native = reader
            bounds = _cut(self.layout[1])
            self.pieces = len(bounds) - 1
            self.job = lib.sdpieces_read(native, self.fh.fileno(), self.room.data_ptr(),
                                         self.layout[0], (ctypes.c_int64 * len(bounds))(*bounds),
                                         self.pieces)

    def _timed(self, read, *args):
        """``read(*args)``, its interval kept for the span."""
        start = perf_counter_ns()
        try:
            return read(*args)
        finally:
            self.times = (start, perf_counter_ns())

    def _finish(self):
        """What the read gives once it has ended, read inline where nothing
        was handed out: a 16-bit file's bytes read, or a decode's (samples,
        rate); the file closed either way. Raises what the read raised."""
        try:
            if self.job is not None:
                lib, native = _piece_reader()
                times = (ctypes.c_int64 * 2)()
                got = lib.sdpieces_wait(native, self.job, times)
                self.job, self.times = None, tuple(times)
                if got < 0:
                    raise OSError(-got, os.strerror(-got))
            elif self.task is not None:
                got = self.task.result()
            elif self.layout is None:
                got = self._timed(read_audio, self.path)
            else:
                offset, length = self.layout[:2]
                got = self._timed(_read_range_into, self.fh.fileno(),
                                  memoryview(self.room.numpy())[:length], offset)
            self.direct = int(self.layout is not None)
            return got
        finally:
            if self.fh is not None:
                self.fh.close()

    def to_device(self) -> tuple[torch.Tensor, int]:
        """The file's ``[n, channels]`` samples as float32 on the device, and
        its rate, once its read is done: a 16-bit PCM WAV's codes uploaded
        as int16 and scaled by 2**-15 on the device (every int16 and its
        product are exact in float32, so the samples equal
        :func:`read_audio`'s bit for bit); any other file's decoded block
        copied into the room, or into a larger one, and uploaded. Raises
        what the read raised, with the room handed back."""
        ring = _host_ring(self.device)
        try:
            got = self._finish()
        except BaseException:
            ring.release(self.room)
            raise
        if self.layout is None:
            samples, rate = got
            return _stage(np.asarray(samples, np.float32), self.device, self.room), rate
        _, _, channels, rate = self.layout
        n = got // (2 * channels)  # whole frames
        timing.record("corpus.stage", *self.waited, lanes=channels, samples=n * channels,
                      staged_samples=n * channels)
        with timing.span("corpus.copy_in"):
            codes = self.room[: n * 2 * channels].view(torch.int16).view(n, channels)
            samples = codes.to(self.device, non_blocking=True).to(torch.float32)  # a CPU: a copy
            ring.uploaded(self.device, self.room)
            return samples.mul_(2.0**-15), rate

    def abandon(self) -> None:
        """Wait for the read handed out, close the file, and hand its room
        back."""
        if self.job is not None or self.task is not None:
            with contextlib.suppress(Exception):
                self._finish()
        if self.fh is not None:
            self.fh.close()
        _host_ring(self.device).release(self.room)


def _record_reads(reads: Sequence[_FileRead]) -> None:
    """One ``corpus.read`` span for each of a scan's ``reads`` that ran,
    from its start to its end, with its ``direct`` and ``pieces`` counts
    and ``inflight``, the reads of the scan in flight as it started, itself
    included."""
    ran = [r for r in reads if r.times is not None]
    for r in ran:
        start = r.times[0]
        inflight = 1 + sum(o.times[0] <= start < o.times[1] for o in ran if o is not r)
        timing.record("corpus.read", *r.times, direct=r.direct, inflight=inflight,
                      pieces=r.pieces)


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
    here = [isinstance(s, torch.Tensor) and s.device == device for s in streams]
    _host_ring(device).reserve(device, _ring_bytes(  # float32, one at a time
        [4 * (s.numel() if isinstance(s, torch.Tensor) else np.size(s))
         for s, h in zip(streams, here) if not h], 1))
    streams = [s.reshape(-1) if h
               else _stage(np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s,
                                      np.float32).reshape(-1), device)
               for s, h in zip(streams, here)]
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

    Each file's samples cross to ``device`` once (:class:`_FileRead`: the
    host buffer, one upload); resampling and the batch stay there. Up to
    :func:`_read_workers` files are read ahead, each into its room of the
    host buffer (one CPU: inline): a 16-bit file's data chunk in pieces,
    taken in file order by the piece reader's threads, so that files land
    one after another; any other file on the process's pool. The calling
    thread uploads each file once all of it has landed, reports a read's
    failure and emits everything in file order, and waits for every read it
    handed out before it returns or raises.

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
        workers = _read_workers(len(paths))
        _host_ring(device).reserve(device, _ring_bytes(sizes, workers))  # grown once
        threads = _read_workers(_READ_CAP)
        pool = _read_pool(threads) if threads > 1 else None  # one CPU: inline
        ahead = iter(zip(paths, sizes))
        reads: collections.deque[_FileRead] = collections.deque()
        opened: list[_FileRead] = []
        try:
            while True:
                # up to ``workers`` files read ahead, in path order, each into its
                # room: their headers walked here before any of them is handed out,
                # since the walks slow down many times over under the reads, and
                # on other threads too (PERF.md)
                held = len(reads)
                reads.extend(_FileRead(p, device, size)
                             for p, size in itertools.islice(ahead, workers - held))
                fresh = list(itertools.islice(reads, held, None))
                opened += fresh
                for read in fresh:
                    read.hand_out(pool)
                if not reads:
                    break
                read = reads.popleft()
                p = read.path
                try:
                    samples, rate = read.to_device()
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
        finally:  # no read outlives the scan: a later scan reuses the rooms
            for read in reads:
                read.abandon()
            _record_reads(opened)
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
