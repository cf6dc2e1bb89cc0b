"""Shared on-demand build helper for the native C++ components.

Three modules ship a C++ counterpart that is compiled on first use with
the system toolchain (the reference links its native pieces at Xcode
build time — project.pbxproj targets; here the build is lazy so the
Python package works without a compile step): runtime.ring_buffer
(native/ring_buffer.cpp), runtime.arduino NativeFirmwareTransport
(native/arduino_firmware.cpp), and utils.av_codec (native/av_codec.cpp).
They share this one build-and-rename sequence instead of three drifting
copies. The sources are the repository's ``native/`` directory
(:data:`NATIVE_SRC`); the libraries go to ``build/native/``
(:data:`NATIVE_BUILD`, which ``.gitignore`` lists), so this package never
loads a library that another package built.

The compile goes to a per-process temp name and is ``os.rename``d into
place — atomic on POSIX — so another process racing the first build
(parallel pytest, a ResilientDetector child) can never ``CDLL`` a
half-written ``.so``; a failed compile removes its temp file.
"""

from __future__ import annotations

import os
import subprocess
from typing import Sequence

__all__ = ["NativeBuildError", "ensure_native_library", "NATIVE_SRC", "NATIVE_BUILD"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SRC = os.path.join(_REPO, "native")
NATIVE_BUILD = os.path.join(_REPO, "build", "native")


class NativeBuildError(RuntimeError):
    """The on-demand g++ build of a native component failed. ``stderr``
    carries the compiler output (empty when the toolchain itself or the
    source file was unavailable)."""

    def __init__(self, message: str, stderr: str = ""):
        super().__init__(message)
        self.stderr = stderr


def ensure_native_library(
    src: str,
    out: str,
    link: Sequence[str] = (),
    extra_flags: Sequence[str] = (),
) -> str:
    """Build shared library ``out`` from ``src`` unless it already exists.

    Raises :class:`NativeBuildError` when the source is missing, g++ is
    unavailable, or the compile fails; returns ``out`` on success.
    """
    if os.path.exists(out):
        return out
    if not os.path.exists(src):
        raise NativeBuildError(f"native source {src} not found")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        proc = subprocess.run(
            ["g++", "-O2", "-Wall", *extra_flags, "-std=c++17", "-fPIC",
             "-shared", "-o", tmp, src, *link],
            capture_output=True,
        )
    except OSError as e:
        raise NativeBuildError(f"C++ toolchain unavailable (g++: {e})") from e
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise NativeBuildError(
            f"native compile of {os.path.basename(src)} failed",
            stderr=proc.stderr.decode(errors="replace"),
        )
    os.rename(tmp, out)
    return out
