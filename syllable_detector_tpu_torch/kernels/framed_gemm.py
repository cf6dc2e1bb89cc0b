"""Framed GEMM: ``frames(x) @ G`` with the frames built on the card.

Replaces the JAX package's Pallas kernel (``kernels/framed_gemm.py``,
``framed_gemm``), which the polyphase resampler runs on: frame k of ``x``
is ``x[gap + k*hop : gap + k*hop + window]``, zero-padded past the end,
and the result is the ``[n_frames, window] @ [window, m]`` product without
the frame matrix ever being written to device memory. ``gap`` and ``hop``
come from ``window_overlap`` as in ``ops.stft`` (a negative overlap is a
gap before every frame).

:func:`framed_gemm` launches the kernel of ``csrc/framed_gemm.cu`` for a
CUDA tensor, raising rather than falling back, and runs the plain PyTorch
version, :func:`framed_gemm_reference`, for a CPU tensor. Launches are
counted in :data:`FRAMED_GEMM_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length, normalize_overlap

__all__ = ["FRAMED_GEMM_LAUNCHES", "framed_gemm", "framed_gemm_reference"]

# Kernel launches in this process; reset to 0 before a run whose launches
# are to be counted.
FRAMED_GEMM_LAUNCHES = 0


def framed_gemm_reference(
    x: torch.Tensor, g: torch.Tensor, window: int, window_overlap: int, n_frames: int
) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``frame_signal(x) @ g``, [n] x
    [window, m] -> [n_frames, m] float32, on any device."""
    return frame_signal(x, n_frames, window, window_overlap) @ g


def framed_gemm(
    x: torch.Tensor, g: torch.Tensor, window: int, window_overlap: int, n_frames: int
) -> torch.Tensor:
    """``frame_signal(x, n_frames, window, window_overlap) @ g``: [n] float32
    x [window, m] float32 -> [n_frames, m] float32. A CUDA ``x`` launches the
    kernel, or raises; a CPU ``x`` runs :func:`framed_gemm_reference`."""
    global FRAMED_GEMM_LAUNCHES
    if g.dim() != 2 or g.shape[0] != window:
        raise ValueError(f"g of shape {tuple(g.shape)} does not have {window} rows")
    if x.device.type == "cpu":
        return framed_gemm_reference(x, g, window, window_overlap, n_frames)
    _check_launchable(x, g)
    m = g.shape[1]
    if n_frames <= 0:
        return x.new_zeros((0, m))
    lib = _library()
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window, window_overlap)
    out = torch.empty((n_frames, m), dtype=torch.float32, device=x.device)
    err = lib.sd_framed_gemm(
        x.data_ptr(), x.shape[0], g.data_ptr(), window, m, hop, gap, n_frames,
        out.data_ptr(),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"framed GEMM kernel launch failed (window {window}, {m} columns, hop {hop}): "
            f"{lib.sd_framed_gemm_error_string(err).decode()} (cudaError {err})"
        )
    FRAMED_GEMM_LAUNCHES += 1
    return out


def _check_launchable(x: torch.Tensor, g: torch.Tensor) -> None:
    """Raise unless ``x`` and ``g`` are contiguous float32 tensors on one
    Hopper card."""
    if x.device.type != "cuda":
        raise ValueError(f"no framed GEMM kernel for device {x.device}")
    if g.device != x.device:
        raise ValueError("g and the samples lie on different devices")
    for name, t, dim in (("samples", x, 1), ("g", g, 2)):
        if t.dtype != torch.float32 or t.dim() != dim or not t.is_contiguous():
            raise ValueError(
                f"the framed GEMM kernel takes contiguous float32 {name} of rank {dim}, "
                f"got {t.dtype} of shape {tuple(t.shape)}"
            )
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(
            "the framed GEMM kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(x.device)} is not"
        )


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound kernel library (built at the first launch)."""
    from syllable_detector_tpu_torch.kernels import _build

    lib = _build.load("framed_gemm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sd_framed_gemm.argtypes = [p, ll, p, i, i, i, i, ll, p, i, p]
    lib.sd_framed_gemm.restype = i
    lib.sd_framed_gemm_error_string.argtypes = [i]
    lib.sd_framed_gemm_error_string.restype = ctypes.c_char_p
    return lib
