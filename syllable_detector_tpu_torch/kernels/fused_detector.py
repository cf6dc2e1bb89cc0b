"""Fused STFT + feature + MLP detection: the CUDA kernel and its plain version.

Replaces the JAX package's Pallas kernel (``kernels/fused_detector.py``,
``_fused_call`` / ``_make_kernel``) on its single-stream path
(``fused_offline_outputs``, raw samples, full fp32). The algebra:

  * window multiply + zero-pad + DFT + band slice fold into one
    ``[window, 2*bins]`` matrix C (re | im);
  * the first layer over the stacked feature vector is a T-tap convolution
    over the frame axis, with the affine input chain (mapminmax / mapstd)
    folded into its weights and bias; the feature matrix is never built;
  * l2normalize needs only the sliding sum of per-frame row sums of squares;
  * the output chain's reverse mapping is one affine after the last layer.

:func:`fold_constants` computes those operands in float64 and casts them
once. :func:`fused_offline_outputs` launches ``csrc/fused_detector.cu`` for
a CUDA tensor and runs :func:`fused_offline_outputs_reference` (the same
folded algebra in plain torch) for a CPU tensor. The kernel's launch count
is :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from syllable_detector_tpu_torch.models.detector import WINDOW, DetectorSpec
from syllable_detector_tpu_torch.ops.processing import (
    fold_input_affines,
    fold_output_affines,
)
from syllable_detector_tpu_torch.ops.stft import (
    band_dft_matrices,
    frame_signal,
    normalize_overlap,
    num_frames,
)
from syllable_detector_tpu_torch.ops.transfer import apply_transfer

__all__ = [
    "LAUNCHES",
    "FusedOperands",
    "fusable",
    "fold_constants",
    "fused_offline_outputs",
    "fused_offline_outputs_reference",
]

# Evaluations per CTA. At the sample geometry one CTA then stages ~33 KB of
# shared memory (samples, spectrogram, activations). Measured on an H100:
# within 2 % of the best tile for one CLI drain step (~500 evaluations) and
# within 13 % for a 60 s stream (PERF.md).
TILE = 32
# Dynamic shared memory one CTA may opt in to on Hopper (227 KB).
SMEM_LIMIT = 232448

SCALING_CODES = {"linear": 0, "log": 1, "db": 2}
TRANSFER_CODES = {"PureLin": 0, "TanSig": 1, "LogSig": 2, "SatLin": 3}
DB_PER_NEPER = np.float32(20.0 / np.log(10.0))

# Kernel launches made by fused_offline_outputs in this process; reset it to
# 0 before a run whose launches are to be counted.
LAUNCHES = 0


class FusedOperands(NamedTuple):
    """Folded float32 operands of one detector, all on one device."""

    c: torch.Tensor  # [window, 2*bins]: re | im, window folded in
    w1: torch.Tensor  # [T, bins, h1]: first layer, input affines folded in
    c1: torch.Tensor  # [h1]
    mids: tuple  # ((w [in, out], b [out]), ...) per later layer
    out_a: torch.Tensor  # [outputs]
    out_c: torch.Tensor  # [outputs]
    has_l2: bool
    mids_flat: torch.Tensor  # mids concatenated (w, b, w, b, ...) for the kernel


def fusable(spec: DetectorSpec) -> bool:
    """Whether the config fits the fused algebra (the JAX package's rule)."""
    for name in spec.net.input_processing:
        if name not in ("l2normalize", "mapminmax", "mapstd", "passthrough"):
            return False
    # l2normalize must come first if present, so the affines fold into W1
    names = [n for n in spec.net.input_processing if n != "passthrough"]
    if "l2normalize" in names[1:]:
        return False
    for name in spec.net.output_processing:
        if name not in ("mapminmax", "mapstd", "passthrough"):
            return False
    for t in spec.net.transfers:
        if t not in ("TanSig", "LogSig", "PureLin", "SatLin"):
            return False
    return spec.scaling in ("linear", "log", "db")


def fold_constants(spec: DetectorSpec, params: dict, device) -> FusedOperands:
    """Fold the spec and net into the fused operands (float64, cast once)."""
    if not fusable(spec):
        raise ValueError(
            "spec is not fusable (callers must check fusable(spec) first)"
        )
    b = spec.n_bins
    t_range = spec.time_range
    c_re, c_im = band_dft_matrices(
        spec.fourier_length, spec.window_length, WINDOW, spec.bins
    )
    c = np.concatenate([c_re, c_im], axis=1)

    feat_scale, feat_shift, has_l2 = fold_input_affines(
        spec.net.input_processing, params["process_inputs"], t_range * b
    )
    layers = [
        {k: v.detach().cpu().numpy().astype(np.float64) for k, v in layer.items()}
        for layer in params["layers"]
    ]
    w1 = layers[0]["w"]  # [H, D]
    # W1 @ (x*scale + shift) + b1 = (W1*scale) @ x + (b1 + W1 @ shift)
    w1_scaled = w1 * feat_scale[None, :]
    c1 = layers[0]["b"] + w1 @ feat_shift
    # feature d = t*bins + k, so [D, H] -> [T, bins, H]
    w1_taps = w1_scaled.T.reshape(t_range, b, w1.shape[0])

    mids = [(layer["w"].T, layer["b"]) for layer in layers[1:]]
    out_a, out_c = fold_output_affines(
        spec.net.output_processing, params["process_outputs"], spec.net.outputs
    )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    flat = [a.reshape(-1) for w, bb in mids for a in (w, bb)]
    return FusedOperands(
        c=dev(c),
        w1=dev(w1_taps),
        c1=dev(c1),
        mids=tuple((dev(w), dev(bb)) for w, bb in mids),
        out_a=dev(out_a),
        out_c=dev(out_c),
        has_l2=has_l2,
        mids_flat=dev(np.concatenate(flat) if flat else np.zeros(0)),
    )


def _n_evals(spec: DetectorSpec, n: int) -> int:
    f = num_frames(n, spec.window_length, spec.window_overlap)
    return max(0, f - spec.time_range + 1)


def fused_offline_outputs_reference(
    spec: DetectorSpec, folded: FusedOperands, x: torch.Tensor
) -> torch.Tensor:
    """The kernel's plain PyTorch version: [n] -> [E, outputs], the same
    folded algebra as ``csrc/fused_detector.cu`` on any device."""
    t_range = spec.time_range
    n_evals = _n_evals(spec, x.shape[0])
    if n_evals == 0:
        return x.new_zeros((0, spec.net.outputs))
    f = n_evals + t_range - 1
    frames = frame_signal(x, f, spec.window_length, spec.window_overlap)
    big = frames @ folded.c
    b = spec.n_bins
    mag = torch.sqrt(big[:, :b] * big[:, :b] + big[:, b:] * big[:, b:])
    if spec.scaling == "log":
        mag = torch.log(mag)
    elif spec.scaling == "db":
        mag = DB_PER_NEPER * torch.log(mag)
    acc = sum(mag[t : t + n_evals] @ folded.w1[t] for t in range(t_range))
    if folded.has_l2:
        rowsq = torch.sum(mag * mag, dim=1)
        norm = sum(rowsq[t : t + n_evals] for t in range(t_range))
        acc = acc / torch.sqrt(norm)[:, None]
    transfers = spec.net.transfers
    h = apply_transfer(acc + folded.c1, transfers[0])
    for (w, bb), name in zip(folded.mids, transfers[1:]):
        h = apply_transfer(h @ w + bb, name)
    return h * folded.out_a + folded.out_c


def fused_offline_outputs(
    spec: DetectorSpec,
    params: dict,
    x: torch.Tensor,
    folded: FusedOperands | None = None,
) -> torch.Tensor:
    """Whole-signal detection through the fused kernel: [n] -> [E, outputs].

    A CUDA ``x`` launches the kernel, or raises; it never falls back. A CPU
    ``x`` runs :func:`fused_offline_outputs_reference`. ``folded`` (from
    :func:`fold_constants` on ``x``'s device) saves refolding per call.
    """
    if folded is None:
        folded = fold_constants(spec, params, x.device)
    if x.device.type == "cpu":
        return fused_offline_outputs_reference(spec, folded, x)
    if x.device.type != "cuda":
        raise ValueError(f"no fused detector kernel for device {x.device}")
    return _launch(spec, folded, x)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sd_fused_detector.argtypes = (
        [p, ll, ll] + [p] * 7 + [i] * 9 + [p, p, i, p]
    )
    lib.sd_fused_detector.restype = i
    lib.sd_fused_detector_smem_bytes.argtypes = [i] * 7
    lib.sd_fused_detector_smem_bytes.restype = ll
    lib.sd_max_layers.argtypes = []
    lib.sd_max_layers.restype = i
    lib.sd_error_string.argtypes = [i]
    lib.sd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound kernel library (built at the first launch)."""
    from syllable_detector_tpu_torch.kernels import _build

    return _bind(_build.load("fused_detector"))


def _launch(
    spec: DetectorSpec, folded: FusedOperands, x: torch.Tensor
) -> torch.Tensor:
    global LAUNCHES
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            "the fused kernel takes a contiguous 1-D float32 tensor, got "
            f"{x.dtype} of shape {tuple(x.shape)}"
        )
    operands = (folded.c, folded.w1, folded.c1, folded.mids_flat,
                folded.out_a, folded.out_c)
    if any(o.device != x.device for o in operands):
        raise ValueError("folded operands and samples lie on different devices")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(
            "the fused kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(x.device)} is not"
        )
    n_evals = _n_evals(spec, x.shape[0])
    if n_evals == 0:
        return x.new_zeros((0, spec.net.outputs))

    lib = _library()
    widths = [w for _, w in spec.net.layer_sizes]
    if len(widths) > lib.sd_max_layers():
        raise ValueError(
            f"the fused kernel takes at most {lib.sd_max_layers()} layers"
        )
    gap, _ = normalize_overlap(spec.window_overlap)
    geometry = (spec.window_length, spec.hop, gap, spec.n_bins, spec.time_range)
    smem = lib.sd_fused_detector_smem_bytes(*geometry, TILE, max(widths))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the fused kernel needs {smem} bytes of shared memory per CTA "
            f"at this geometry; the card offers {SMEM_LIMIT}"
        )
    out = torch.empty(
        (n_evals, spec.net.outputs), dtype=torch.float32, device=x.device
    )
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_transfers = (ctypes.c_int * len(widths))(
        *(TRANSFER_CODES[t] for t in spec.net.transfers)
    )
    err = lib.sd_fused_detector(
        x.data_ptr(), x.shape[0], n_evals,
        *(o.data_ptr() for o in operands), out.data_ptr(),
        *geometry, SCALING_CODES[spec.scaling], int(folded.has_l2), TILE,
        len(widths), c_widths, c_transfers,
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "fused detector kernel launch failed: "
            f"{lib.sd_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES += 1
    return out
