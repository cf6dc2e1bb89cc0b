"""Build the package's CUDA sources with nvcc at first use, and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/torch_kernels/lib<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``). The hash covers the source and the
flags, so an edited kernel rebuilds; the library is loaded with ctypes.
Nothing is built when a module is imported: only :func:`load` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "build", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# No --use_fast_math: the kernels rely on IEEE tanhf/expf/logf/sqrtf and
# division (see csrc/fused_detector.cu). -Xptxas -v writes each kernel's
# registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use"
    )


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless a build of the same source and flags
    exists. Returns (library path, build seconds, nvcc's log); the seconds
    are 0.0 and the log is the stored one when nothing was built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return lib, 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, seconds, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path, _, _ = build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
