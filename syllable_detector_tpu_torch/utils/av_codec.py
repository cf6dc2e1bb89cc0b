"""AAC/M4A/ALAC-wide audio ingest via the native FFmpeg shim.

The reference CLI decodes anything AVFoundation reads — AAC/M4A/ALAC
included (reference: SyllableDetectorCLI/main.swift:63-76). Those codecs
have no flat-ABI decoder library like libmpg123/libvorbisfile, so this
route goes through ``native/av_codec.cpp`` — a small C++ shim over
libavformat/libavcodec/libswresample exposing a two-function C ABI
(decode-to-float32, encode-from-float32). The shim auto-builds on first
use like the ring buffer, and everything degrades gracefully when the
FFmpeg libraries or a toolchain are absent.

Error contract matches utils.codecs: ``RuntimeError`` when the backend is
unavailable, ``ValueError`` for undecodable input (ingest callers catch
(OSError, ValueError) per file).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Union

import numpy as np

from syllable_detector_tpu_torch.utils.native_build import (
    NATIVE_BUILD,
    NATIVE_SRC,
    NativeBuildError,
    ensure_native_library,
)

__all__ = ["av_available", "read_av", "write_av"]

_LIB_PATH = os.path.join(NATIVE_BUILD, "libsdav.so")
_AV_LINK = ["-lavformat", "-lavcodec", "-lswresample", "-lavutil"]

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _load_library():
    global _lib, _lib_tried
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            ensure_native_library(
                os.path.join(NATIVE_SRC, "av_codec.cpp"),
                _LIB_PATH,
                link=_AV_LINK,
            )
        except NativeBuildError:
            return None  # no toolchain or no FFmpeg dev libraries
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.sdav_decode_file.restype = ctypes.c_int
        lib.sdav_decode_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.sdav_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.sdav_encode_file.restype = ctypes.c_int
        lib.sdav_encode_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _reset_for_test():
    global _lib, _lib_tried
    with _lib_lock:
        _lib = None
        _lib_tried = False


def av_available() -> bool:
    """True when the native FFmpeg shim is loadable (building it on first
    call if a toolchain and the FFmpeg dev libraries exist)."""
    return _load_library() is not None


def read_av(path: Union[str, "os.PathLike"]) -> tuple[np.ndarray, int]:
    """Decode any FFmpeg-known audio container/codec (AAC/M4A/ALAC/FLAC/
    CAF/...) -> ([n, channels] float32, rate)."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError(
            "the native FFmpeg shim is unavailable (needs g++ and the "
            "libavformat/libavcodec/libswresample libraries)"
        )
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64(0)
    channels = ctypes.c_int(0)
    rate = ctypes.c_int(0)
    err = ctypes.create_string_buffer(512)
    rc = lib.sdav_decode_file(
        str(path).encode(),
        ctypes.byref(out),
        ctypes.byref(frames),
        ctypes.byref(channels),
        ctypes.byref(rate),
        err,
        len(err),
    )
    if rc != 0:
        raise ValueError(
            f"{path}: FFmpeg decode failed: {err.value.decode(errors='replace')}"
        )
    try:
        n, ch = int(frames.value), int(channels.value)
        if n == 0:
            return np.zeros((0, max(1, ch)), np.float32), int(rate.value)
        data = np.ctypeslib.as_array(out, shape=(n * ch,)).copy()
        return data.reshape(n, ch), int(rate.value)
    finally:
        lib.sdav_free(out)


def write_av(
    path: Union[str, "os.PathLike"],
    samples: np.ndarray,
    rate: int,
    codec: Optional[str] = None,
) -> None:
    """Encode [n] or [n, channels] float32 samples into the container the
    file extension implies (.m4a -> AAC by default); ``codec`` picks a
    specific FFmpeg encoder by name (e.g. 'alac', 'flac', 'libmp3lame')."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError(
            "the native FFmpeg shim is unavailable (needs g++ and the "
            "libavformat/libavcodec/libswresample libraries)"
        )
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    # interleave and BIND to a local across the call (`.ctypes.data` of a
    # temporary is a bare int: the array could be freed mid-call)
    flat = np.ascontiguousarray(samples.reshape(-1))
    err = ctypes.create_string_buffer(512)
    rc = lib.sdav_encode_file(
        str(path).encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        channels,
        int(rate),
        codec.encode() if codec else None,
        err,
        len(err),
    )
    del flat
    if rc != 0:
        raise ValueError(
            f"{path}: FFmpeg encode failed: {err.value.decode(errors='replace')}"
        )
