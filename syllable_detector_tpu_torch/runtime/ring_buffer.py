"""Python binding for the native SPSC ring buffer.

Wraps native/ring_buffer.cpp (the TPCircularBuffer equivalent; reference:
Common/TPCircularBuffer/TPCircularBuffer.h:53-189) via ctypes, with a typed
float32 convenience layer on top — the reference stores raw float samples and
spectral frame slices in its rings (SyllableDetector.swift:62-67,
CircularShortTimeFourierTransform.swift:124-128).

The shared library is built on demand with the system compiler; if no
compiler is available a pure-Python fallback with the same API (lock-based,
correct but slower) keeps the framework usable.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from syllable_detector_tpu_torch.utils.native_build import (
    NATIVE_BUILD,
    NATIVE_SRC,
    NativeBuildError,
    ensure_native_library,
)

__all__ = ["RingBuffer", "RingBlockWriter", "DrainStager", "native_available"]

_LIB_PATH = os.path.join(NATIVE_BUILD, "libsdring.so")

_lib = None
_lib_lock = threading.Lock()


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = os.path.join(NATIVE_SRC, "ring_buffer.cpp")
        try:
            # -O3 -march=native vectorizes the drain-staging quantizer
            # (sdstage_batch: int16 23->3.9 ms per 6.5M samples on AVX2);
            # retry plain when the toolchain rejects -march=native
            try:
                ensure_native_library(
                    src, _LIB_PATH, extra_flags=("-O3", "-march=native")
                )
            except NativeBuildError:
                ensure_native_library(src, _LIB_PATH)
        except NativeBuildError:
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.sdring_create.restype = ctypes.c_void_p
        lib.sdring_create.argtypes = [ctypes.c_int32]
        lib.sdring_destroy.argtypes = [ctypes.c_void_p]
        lib.sdring_capacity.restype = ctypes.c_int32
        lib.sdring_capacity.argtypes = [ctypes.c_void_p]
        lib.sdring_fill.restype = ctypes.c_int32
        lib.sdring_fill.argtypes = [ctypes.c_void_p]
        lib.sdring_head.restype = ctypes.c_void_p
        lib.sdring_head.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.sdring_produce.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sdring_produce_bytes.restype = ctypes.c_int32
        lib.sdring_produce_bytes.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.sdring_tail.restype = ctypes.c_void_p
        lib.sdring_tail.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.sdring_consume.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sdring_clear.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "sdring_produce_batch"):  # old cached .so: degrade
            lib.sdring_produce_batch.restype = ctypes.c_int32
            lib.sdring_produce_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int32,
                ctypes.c_void_p,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
        if hasattr(lib, "sdstage_batch"):  # old cached .so: degrade
            lib.sdstage_batch.restype = ctypes.c_int32
            lib.sdstage_batch.argtypes = [
                ctypes.c_void_p,  # const float* const* srcs
                ctypes.c_void_p,  # const int64* lens
                ctypes.c_int32,  # n_lanes
                ctypes.c_void_p,  # xs
                ctypes.c_void_p,  # int64* prev
                ctypes.c_int64,  # need
                ctypes.c_int32,  # mode
                ctypes.c_void_p,  # lut
            ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


class _NativeRing:
    def __init__(self, capacity_bytes: int):
        lib = _load_library()
        self._lib = lib
        self._ptr = lib.sdring_create(int(capacity_bytes))
        if not self._ptr:
            raise MemoryError("Unable to allocate circular buffer.")

    @property
    def capacity(self) -> int:
        return self._lib.sdring_capacity(self._ptr)

    @property
    def fill(self) -> int:
        return self._lib.sdring_fill(self._ptr)

    def produce_bytes(self, data: bytes | memoryview | np.ndarray) -> bool:
        buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
        buf = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
        ok = self._lib.sdring_produce_bytes(
            self._ptr, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
        )
        return bool(ok)

    def peek(self, max_bytes: int | None = None) -> np.ndarray:
        avail = ctypes.c_int32(0)
        tail = self._lib.sdring_tail(self._ptr, ctypes.byref(avail))
        n = avail.value if max_bytes is None else min(avail.value, max_bytes)
        if n <= 0 or not tail:
            return np.zeros(0, np.uint8)
        raw = (ctypes.c_uint8 * n).from_address(tail)
        return np.frombuffer(raw, np.uint8).copy()

    def consume(self, n_bytes: int) -> None:
        self._lib.sdring_consume(self._ptr, int(n_bytes))

    def clear(self) -> None:
        self._lib.sdring_clear(self._ptr)

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr and self._lib:
            self._lib.sdring_destroy(ptr)


class _PythonRing:
    """Lock-based fallback with identical semantics."""

    def __init__(self, capacity_bytes: int):
        page = 4096
        cap = ((int(capacity_bytes) + page - 1) // page) * page
        self._buf = bytearray(cap)
        self._cap = cap
        self._head = 0
        self._tail = 0
        self._fill = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def fill(self) -> int:
        with self._lock:
            return self._fill

    def produce_bytes(self, data) -> bool:
        buf = np.asarray(data).view(np.uint8).reshape(-1).tobytes() if isinstance(
            data, np.ndarray
        ) else bytes(data)
        n = len(buf)
        with self._lock:
            if self._cap - self._fill < n:
                return False
            end = self._head + n
            if end <= self._cap:
                self._buf[self._head : end] = buf
            else:
                k = self._cap - self._head
                self._buf[self._head :] = buf[:k]
                self._buf[: end - self._cap] = buf[k:]
            self._head = end % self._cap
            self._fill += n
            return True

    def peek(self, max_bytes: int | None = None) -> np.ndarray:
        with self._lock:
            n = self._fill if max_bytes is None else min(self._fill, max_bytes)
            if n <= 0:
                return np.zeros(0, np.uint8)
            end = self._tail + n
            if end <= self._cap:
                out = bytes(self._buf[self._tail : end])
            else:
                out = bytes(self._buf[self._tail :]) + bytes(
                    self._buf[: end - self._cap]
                )
            return np.frombuffer(out, np.uint8).copy()

    def consume(self, n_bytes: int) -> None:
        with self._lock:
            self._tail = (self._tail + n_bytes) % self._cap
            self._fill -= n_bytes

    def clear(self) -> None:
        with self._lock:
            self._tail = self._head
            self._fill = 0


class RingBuffer:
    """Typed float32 SPSC ring.

    produce/consume work in float32 samples; backed by the native
    VM-mirrored ring when available.
    """

    ITEM = 4  # float32 bytes

    def __init__(self, capacity_samples: int, force_python: bool = False):
        nbytes = int(capacity_samples) * self.ITEM
        if not force_python and native_available():
            self._ring = _NativeRing(nbytes)
            self.native = True
        else:
            self._ring = _PythonRing(nbytes)
            self.native = False

    @property
    def capacity(self) -> int:
        return self._ring.capacity // self.ITEM

    @property
    def fill(self) -> int:
        return self._ring.fill // self.ITEM

    def produce(self, samples: np.ndarray) -> bool:
        samples = np.ascontiguousarray(samples, np.float32)
        return self._ring.produce_bytes(samples.view(np.uint8).reshape(-1))

    def peek(self, max_samples: int | None = None) -> np.ndarray:
        raw = self._ring.peek(None if max_samples is None else max_samples * self.ITEM)
        n = (len(raw) // self.ITEM) * self.ITEM
        return raw[:n].view(np.float32)

    def consume(self, n_samples: int) -> None:
        self._ring.consume(int(n_samples) * self.ITEM)

    def clear(self) -> None:
        self._ring.clear()


class DrainStager:
    """Stage + quantize a whole DetectorBank drain round in ONE native
    call (``sdstage_batch``).

    The Python staging loop — per lane: clip copy, scale, rint, LUT
    gather, row store, stale-tail zero — measured **62% of one host
    core at 384 lanes** (scripts/host_cost_profile.py), the worker-side
    wall the r5 live campaign named. This folds it into one pass per
    lane at memory speed. The caller fills :attr:`ptrs`/:attr:`lens`
    (one entry per lane; ``lens[i] = 0`` skips a lane but still zeroes
    its stale tail) and passes the staging buffer + per-row fill
    watermarks; quantization semantics are bit-identical to the numpy
    path for finite samples (test-pinned).
    """

    MODES = {"float32": 0, "int16": 1, "mulaw8": 2}

    def __init__(self, n_lanes: int):
        lib = _load_library()
        self._lib = (
            lib if lib is not None and hasattr(lib, "sdstage_batch") else None
        )
        self.n_lanes = int(n_lanes)
        # caller-filled per-round views (kept here so the hot loop never
        # allocates): source pointer + length per lane
        self.ptrs = np.zeros(self.n_lanes, np.uint64)
        self.lens = np.zeros(self.n_lanes, np.int64)
        self._ptrs_addr = self.ptrs.ctypes.data
        self._lens_addr = self.lens.ctypes.data

    @property
    def available(self) -> bool:
        return self._lib is not None

    def stage(
        self,
        xs: np.ndarray,
        prev: np.ndarray,
        mode: int,
        lut_addr: int = 0,
        keepalive=None,
    ) -> None:
        """One native call: quantize+copy every lane row whose pointer
        is set in :attr:`ptrs`/:attr:`lens` into ``xs`` and re-zero
        stale tails per ``prev`` (updated in place). ``keepalive`` must
        bind the source arrays through the call — a bare
        ``.ctypes.data`` int does NOT keep its array alive (the
        documented ctypes lifetime trap)."""
        ok = self._lib.sdstage_batch(
            self._ptrs_addr,
            self._lens_addr,
            self.n_lanes,
            xs.ctypes.data,
            prev.ctypes.data,
            xs.shape[1],
            mode,
            lut_addr,
        )
        if not ok:
            raise ValueError(f"sdstage_batch rejected mode {mode}")
        del keepalive


class RingBlockWriter:
    """Produce row i of a ``[len(rings), n]`` float32 block into
    ``rings[i]`` with ONE native call (``sdring_produce_batch``).

    The per-call ctypes overhead (~5-7 us) otherwise dominates the
    capture fan-out at high lane counts (r5 live campaign: the host
    fan-out was the second wall after the wire). The ring-pointer array
    is precomputed once here; ``produce`` then costs one foreign call +
    C memcpys. Falls back to per-ring :meth:`RingBuffer.produce` when
    any ring is the Python fallback or the native lib lacks the symbol
    (an older cached .so)."""

    def __init__(self, rings: list[RingBuffer]):
        self._rings = list(rings)
        n = len(self._rings)
        lib = _load_library()
        self._lib = None
        if (
            n
            and lib is not None
            and hasattr(lib, "sdring_produce_batch")
            and all(r.native for r in self._rings)
        ):
            self._lib = lib
            self._ptrs = (ctypes.c_void_p * n)(
                *[r._ring._ptr for r in self._rings]
            )
            self._ok = np.empty(n, np.uint8)

    def produce(self, block: np.ndarray) -> np.ndarray:
        """Returns a bool[count] per-ring success array (False = that
        ring was full and dropped its row, like RingBuffer.produce)."""
        n = len(self._rings)
        if block.shape[0] != n:
            raise ValueError(
                f"block has {block.shape[0]} rows for {n} rings"
            )
        if self._lib is None:
            return np.array(
                [r.produce(block[i]) for i, r in enumerate(self._rings)],
                bool,
            )
        block = np.ascontiguousarray(block, np.float32)
        self._lib.sdring_produce_batch(
            self._ptrs,
            n,
            block.ctypes.data_as(ctypes.c_void_p),
            block.shape[1] * RingBuffer.ITEM,
            self._ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        # bind `block` through the call above (ctypes .data does not keep
        # the array alive on its own — the documented lifetime trap)
        del block
        return self._ok.astype(bool)
