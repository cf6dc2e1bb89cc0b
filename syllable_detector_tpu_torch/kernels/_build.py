"""Build the package's CUDA sources with nvcc at first use, and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``). A source named in :data:`PARTS` is
compiled in that many parts at once, one nvcc each (``-DSD_PART=k``: the
source instantiates its share of the kernels per part), and the objects
are linked into the library. The hash covers the source, the flags and
the parts, so an edited kernel rebuilds; the library is loaded with ctypes.
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

__all__ = ["load", "build", "BUILD_DIR", "NVCC_FLAGS", "PARTS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# No --use_fast_math: the kernels rely on IEEE tanhf/expf/logf/sqrtf and
# division (see csrc/fused_detector.cu). -Xptxas -v writes each kernel's
# registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Sources compiled in parts at once: the fused detector's three
# shared-memory layouts (csrc/fused_detector.cu, SD_PART).
PARTS = {"fused_detector": 3}

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
    parts = PARTS.get(name, 0)
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(NVCC_FLAGS).encode() + str(parts).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return lib, 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objects = [lib.with_name(f"{lib.stem}.{os.getpid()}.{k}.o") for k in range(parts)]
    t0 = time.perf_counter()
    if parts:
        runs = [_run([*NVCC_FLAGS, f"-DSD_PART={k}", "-c", "-o", str(obj), str(src)])
                for k, obj in enumerate(objects)]
        outs = [run.communicate() for run in runs]
        codes = [run.returncode for run in runs]
        if not any(codes):
            link = _run([*NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)])
            outs.append(link.communicate())
            codes.append(link.returncode)
    else:
        run = _run([*NVCC_FLAGS, "-shared", "-o", str(tmp), str(src)])
        outs, codes = [run.communicate()], [run.returncode]
    seconds = time.perf_counter() - t0
    log = "".join(out + err for out, err in outs)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if any(codes):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, seconds, log


def _run(args: list[str]) -> subprocess.Popen:
    """nvcc with ``args``, started; its output captured as text."""
    return subprocess.Popen([_nvcc(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path, _, _ = build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
