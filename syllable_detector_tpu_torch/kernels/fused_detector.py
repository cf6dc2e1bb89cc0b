"""Fused STFT + feature + MLP detection: the CUDA kernels and their plain versions.

Replaces the JAX package's Pallas kernel (``kernels/fused_detector.py``,
``_fused_call`` / ``_make_kernel``) on every path that reaches it. The
full-fp32 raw-sample paths launch the kernel of ``csrc/fused_detector.cu``:
one stream (``fused_offline_outputs``), a ``[C, n]`` batch with a shared net
or one net per channel (``fused_flat_batch_offline_outputs``,
``fused_batch_offline_outputs``), and the live drain program that reads
that batch from an int16 or mu-law wire (``fused_batch_program``). The
precision tiers (``fast=`` / ``split=``: the two big GEMMs as 1, 3 or 4 bf16
products on the tensor cores, :data:`TIERS`) and the pre-gathered frames
input (``input_mode="frames"``) launch the kernel of
``csrc/fused_detector_tiers.cu``. ``layout="grid"`` runs either kernel over
slabs of ``slab_channels`` lanes, one launch per slab. The algebra:

  * window multiply + zero-pad + DFT + band slice fold into one
    ``[window, 2*bins]`` matrix C (re | im);
  * the first layer over the stacked feature vector is a T-tap convolution
    over the frame axis, with the affine input chain (mapminmax / mapstd)
    folded into its weights and bias; the feature matrix is never built;
  * l2normalize needs only the sliding sum of per-frame row sums of squares;
  * the output chain's reverse mapping is one affine after the last layer.

:func:`fold_constants` computes those operands in float64 and casts them
once (:func:`fold_constants_stacked` for one net per channel). Each entry
launches the kernel for a CUDA tensor, raising rather than falling back,
and runs its plain PyTorch version (:func:`fused_offline_outputs_reference`,
:func:`fused_batch_outputs_reference`, :func:`fused_tier_outputs_reference`,
:func:`fused_frames_outputs_reference`) for a CPU tensor. Launches are
counted per entry: :data:`LAUNCHES` (one stream), :data:`BATCH_LAUNCHES`
(float32 batches, the float32 wire included), :data:`PROGRAM_LAUNCHES`
(the dequantising wires), :data:`TIER_LAUNCHES` (per precision tier),
:data:`FRAMES_LAUNCHES` (frames input) and :data:`GRID_LAUNCHES` (slabs of
the grid layout).
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
    "BATCH_LAUNCHES",
    "PROGRAM_LAUNCHES",
    "TIER_LAUNCHES",
    "FRAMES_LAUNCHES",
    "GRID_LAUNCHES",
    "TIERS",
    "WIRE_DTYPES",
    "FusedOperands",
    "BatchProgram",
    "fusable",
    "fold_constants",
    "fold_constants_stacked",
    "dequant_int16",
    "dequant_mulaw8",
    "dequant",
    "fused_offline_outputs",
    "fused_offline_outputs_reference",
    "fused_batch_outputs_reference",
    "fused_tier_outputs_reference",
    "fused_frames_outputs_reference",
    "fused_flat_batch_offline_outputs",
    "fused_batch_offline_outputs",
    "fused_batch_program",
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

# Kernel launches in this process, per entry; reset them to 0 before a run
# whose launches are to be counted. LAUNCHES: fused_offline_outputs (one
# stream). BATCH_LAUNCHES: fused_flat_batch_offline_outputs (float32
# [C, n], also reached through fused_batch_offline_outputs and a float32
# fused_batch_program). PROGRAM_LAUNCHES: fused_batch_program per
# dequantising wire. TIER_LAUNCHES: launches of the tier kernel per precision
# tier, from any entry. FRAMES_LAUNCHES: fused_offline_outputs with
# input_mode="frames". GRID_LAUNCHES: slab launches of the grid layout
# (fused_batch_offline_outputs with layout="grid" or a tier), either kernel.
LAUNCHES = 0
BATCH_LAUNCHES = 0
PROGRAM_LAUNCHES = {"int16": 0, "mulaw8": 0}
# Precision tiers: bf16 products of (the band DFT GEMM, the first layer's
# conv GEMM); 0 keeps that GEMM in fp32. "fast" is the JAX function's
# fast=True, "split" its split=True, "conv" split="conv", "split4" split=4.
TIERS = {"fast": (1, 1), "split": (3, 3), "conv": (0, 3), "split4": (4, 4)}
TIER_LAUNCHES = {tier: 0 for tier in TIERS}
FRAMES_LAUNCHES = 0
GRID_LAUNCHES = 0
# wmma fragment edge: the tier kernel's GEMM extents are padded to it
FRAG = 16

# Host wire types of a drain round, and their codes in the kernel.
WIRE_DTYPES = {"float32": torch.float32, "int16": torch.int16, "mulaw8": torch.int8}
WIRE_CODES = {"float32": 0, "int16": 1, "mulaw8": 2}
# The JAX program's dequantising constants, as float32 (fused_detector.py
# fused_batch_program): int16 x * 1/32767; mu-law (mu = 255) y = x * 1/127,
# sign(y) * expm1(|y| * ln 256) * 1/255.
INT16_SCALE = np.float32(1.0 / 32767.0)
MULAW_INV127 = np.float32(1.0 / 127.0)
MULAW_LN1MU = np.float32(np.log1p(255.0))
MULAW_INV_MU = np.float32(1.0 / 255.0)


class FusedOperands(NamedTuple):
    """Folded float32 operands of one detector, all on one device. With
    ``per_lane`` every operand but ``c`` has a leading axis of one net per
    channel (:func:`fold_constants_stacked`)."""

    c: torch.Tensor  # [window, 2*bins]: re | im, window folded in
    w1: torch.Tensor  # [T, bins, h1]: first layer, input affines folded in
    c1: torch.Tensor  # [h1]
    mids: tuple  # ((w [in, out], b [out]), ...) per later layer
    out_a: torch.Tensor  # [outputs]
    out_c: torch.Tensor  # [outputs]
    has_l2: bool
    mids_flat: torch.Tensor  # mids concatenated (w, b, w, b, ...) for the kernel
    per_lane: bool = False
    # bf16 halves for the tier kernel, split once per fold: (c_hi, c_lo,
    # w1g_hi, w1g_lo), see split_operands
    tiers: tuple | None = None


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
    c_t, w1_t = dev(c), dev(w1_taps)
    return FusedOperands(
        c=c_t,
        w1=w1_t,
        c1=dev(c1),
        mids=tuple((dev(w), dev(bb)) for w, bb in mids),
        out_a=dev(out_a),
        out_c=dev(out_c),
        has_l2=has_l2,
        mids_flat=dev(np.concatenate(flat) if flat else np.zeros(0)),
        tiers=split_operands(c_t, w1_t),
    )


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _hi_lo(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` as two bfloat16 halves, rounded to nearest even: ``hi =
    bf16(t)``, ``lo = bf16(t - f32(hi))``, the JAX kernel's ``hi_lo``."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.to(torch.float32)).to(torch.bfloat16)


def split_operands(c: torch.Tensor, w1: torch.Tensor) -> tuple:
    """The tier kernel's bf16 operands (c_hi, c_lo, w1g_hi, w1g_lo) of one
    net, from its folded ``c`` [window, 2*bins] and ``w1`` [T, bins, h1].
    The first layer becomes the conv filter bank ``w1g[k, t*h1 + j] =
    w1[t, k, j]``, so that one GEMM over the bins computes all T taps.
    Every extent is padded with zeros to a multiple of 16, the tensor
    cores' fragment, in both halves."""
    window, two_b = c.shape
    c_pad = c.new_zeros((_round_up(window, FRAG), _round_up(two_b, FRAG)))
    c_pad[:window, :two_b] = c
    t_range, b, h1 = w1.shape
    w1g_pad = w1.new_zeros((_round_up(b, FRAG), _round_up(t_range * h1, FRAG)))
    w1g_pad[:b, : t_range * h1] = w1.transpose(0, 1).reshape(b, t_range * h1)
    return (*_hi_lo(c_pad), *_hi_lo(w1g_pad))


def fold_constants_stacked(
    spec: DetectorSpec, params_list, device
) -> FusedOperands:
    """Fold DISTINCT per-channel nets into channel-stacked operands: the
    shared DFT matrix, then each net operand with a leading channel axis.
    Every net folds on its own in float64 and is cast once, as the JAX
    package's ``fold_constants_stacked`` does, so the two agree exactly."""
    if not params_list:
        raise ValueError("params_list must contain at least one network")
    folds = [fold_constants(spec, p, "cpu") for p in params_list]

    def stack(tensors):
        return torch.stack(list(tensors)).to(device)

    f0 = folds[0]
    return FusedOperands(
        c=f0.c.to(device),
        w1=stack(f.w1 for f in folds),
        c1=stack(f.c1 for f in folds),
        mids=tuple(
            (stack(f.mids[i][0] for f in folds), stack(f.mids[i][1] for f in folds))
            for i in range(len(f0.mids))
        ),
        out_a=stack(f.out_a for f in folds),
        out_c=stack(f.out_c for f in folds),
        has_l2=f0.has_l2,
        mids_flat=stack(f.mids_flat for f in folds),
        per_lane=True,
        tiers=(
            f0.tiers[0].to(device),
            f0.tiers[1].to(device),
            stack(f.tiers[2] for f in folds),
            stack(f.tiers[3] for f in folds),
        ),
    )


def dequant_int16(v: torch.Tensor) -> torch.Tensor:
    """The int16 wire's dequantisation: ``v * (1/32767)`` in float32, a
    multiply and not a divide, as the JAX program computes it."""
    return v.to(torch.float32) * float(INT16_SCALE)


def dequant_mulaw8(v: torch.Tensor) -> torch.Tensor:
    """The 8-bit mu-law wire's expansion: ``sign(y) * expm1(|y| * ln 256) /
    255`` with ``y = v / 127``, every constant the JAX program's float32."""
    y = v.to(torch.float32) * float(MULAW_INV127)
    return torch.sign(y) * (torch.expm1(torch.abs(y) * float(MULAW_LN1MU)) * float(MULAW_INV_MU))


def dequant(v: torch.Tensor, wire: str) -> torch.Tensor:
    """Wire samples of type ``wire`` (a :data:`WIRE_DTYPES` key) as float32."""
    if wire == "int16":
        return dequant_int16(v)
    if wire == "mulaw8":
        return dequant_mulaw8(v)
    if wire == "float32":
        return v.to(torch.float32)
    raise ValueError(f"unknown wire_dtype {wire!r}")


def _n_evals(spec: DetectorSpec, n: int) -> int:
    f = num_frames(n, spec.window_length, spec.window_overlap)
    return max(0, f - spec.time_range + 1)


def _tier_of(fast: bool, split) -> str | None:
    """The :data:`TIERS` key of the JAX functions' ``fast`` / ``split``
    arguments (``fast`` wins, as there); None is the full-fp32 tier."""
    if fast:
        return "fast"
    if split is None or split is False:
        return None
    if split is True:
        return "split"
    if split == "conv":
        return "conv"
    if split == 4:
        return "split4"
    raise ValueError(f"unknown split {split!r} (True, 'conv' or 4)")


def _tier_dot(x: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """``x @ w`` as ``passes`` bf16 products accumulated in fp32, in the JAX
    kernel's order (``split_dot``); 0 passes is the fp32 product. The halves
    are exact in float32, so each product is a float32 matmul of them."""
    if passes == 0:
        return x @ w
    (x_hi, x_lo), (w_hi, w_lo) = (
        tuple(h.to(torch.float32) for h in _hi_lo(t)) for t in (x, w)
    )
    acc = x_hi @ w_hi
    if passes >= 3:
        acc = acc + x_hi @ w_lo + x_lo @ w_hi
    if passes == 4:
        acc = acc + x_lo @ w_lo
    return acc


def _outputs_from_frames(
    spec: DetectorSpec,
    folded: FusedOperands,
    frames: torch.Tensor,
    n_evals: int,
    tier: str | None,
) -> torch.Tensor:
    """``[L, F, window]`` frames -> ``[L, n_evals, outputs]``: the folded
    algebra every plain version shares, with the tier's two GEMMs through
    :func:`_tier_dot`."""
    dft_passes, conv_passes = TIERS[tier] if tier else (0, 0)
    t_range = spec.time_range
    big = _tier_dot(frames, folded.c, dft_passes)
    b = spec.n_bins
    mag = torch.sqrt(big[..., :b] * big[..., :b] + big[..., b:] * big[..., b:])
    if spec.scaling == "log":
        mag = torch.log(mag)
    elif spec.scaling == "db":
        mag = DB_PER_NEPER * torch.log(mag)

    def per_lane(v):  # a per-lane [L, d] vector broadcast over evaluations
        return v[:, None, :] if folded.per_lane else v

    w1 = folded.w1 if folded.per_lane else folded.w1[None]
    acc = sum(
        _tier_dot(mag[:, t : t + n_evals], w1[:, t], conv_passes)
        for t in range(t_range)
    )
    if folded.has_l2:
        rowsq = torch.sum(mag * mag, dim=2)
        norm = sum(rowsq[:, t : t + n_evals] for t in range(t_range))
        acc = acc / torch.sqrt(norm)[..., None]
    transfers = spec.net.transfers
    h = apply_transfer(acc + per_lane(folded.c1), transfers[0])
    for (w, bb), name in zip(folded.mids, transfers[1:]):
        h = apply_transfer(h @ w + per_lane(bb), name)
    return h * per_lane(folded.out_a) + per_lane(folded.out_c)


def fused_batch_outputs_reference(
    spec: DetectorSpec,
    folded: FusedOperands,
    xs: torch.Tensor,
    wire: str = "float32",
    n_evals: int | None = None,
    tier: str | None = None,
) -> torch.Tensor:
    """The batched kernels' plain PyTorch version: ``[L, n]`` wire samples
    -> dequantise -> ``[L, E, outputs]``, with one shared net or one net per
    lane (``folded.per_lane``), on any device. ``n_evals`` defaults to every
    evaluation the ``n`` samples hold; ``tier`` is a :data:`TIERS` key or
    None for full fp32. The grid layout's plain version is this function on
    the whole ``[C, n]``."""
    x = dequant(xs, wire)
    lanes, n = x.shape
    if n_evals is None:
        n_evals = _n_evals(spec, n)
    if n_evals <= 0:
        return x.new_zeros((lanes, 0, spec.net.outputs))
    f = n_evals + spec.time_range - 1
    gap, _ = normalize_overlap(spec.window_overlap)
    total = gap + (f - 1) * spec.hop + spec.window_length
    if n < total:
        x = torch.cat([x, x.new_zeros((lanes, total - n))], dim=1)
    frames = x[:, gap:total].unfold(1, spec.window_length, spec.hop)  # [L, F, W]
    return _outputs_from_frames(spec, folded, frames, n_evals, tier)


def fused_offline_outputs_reference(
    spec: DetectorSpec, folded: FusedOperands, x: torch.Tensor
) -> torch.Tensor:
    """The fp32 kernel's plain PyTorch version for one stream: [n] ->
    [E, outputs], the same folded algebra as ``csrc/fused_detector.cu`` on
    any device."""
    return fused_batch_outputs_reference(spec, folded, x[None])[0]


def fused_tier_outputs_reference(
    spec: DetectorSpec,
    folded: FusedOperands,
    xs: torch.Tensor,
    tier: str,
    n_evals: int | None = None,
) -> torch.Tensor:
    """The tier kernel's plain PyTorch version: ``[L, n]`` float32 samples
    -> ``[L, E, outputs]`` with the band DFT and conv GEMMs as the bf16
    products of ``tier`` (a :data:`TIERS` key): halves cast with
    ``.to(torch.bfloat16)``, products as float32 matmuls of the rounded
    halves, summed in the JAX kernel's order."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r} (one of {sorted(TIERS)})")
    return fused_batch_outputs_reference(spec, folded, xs, n_evals=n_evals, tier=tier)


def fused_frames_outputs_reference(
    spec: DetectorSpec,
    folded: FusedOperands,
    frames: torch.Tensor,
    tier: str | None = None,
) -> torch.Tensor:
    """The frames-input kernel's plain PyTorch version: pre-gathered
    ``[F, window]`` frames -> ``[F - timeRange + 1, outputs]``."""
    n_evals = frames.shape[0] - spec.time_range + 1
    if n_evals <= 0:
        return frames.new_zeros((0, spec.net.outputs))
    return _outputs_from_frames(spec, folded, frames[None], n_evals, tier)[0]


def fused_offline_outputs(
    spec: DetectorSpec,
    params: dict,
    x: torch.Tensor,
    folded: FusedOperands | None = None,
    input_mode: str = "raw",
    fast: bool = False,
    split=None,
    packed: bool | None = None,
) -> torch.Tensor:
    """Whole-signal detection through a fused kernel: [n] -> [E, outputs].

    A CUDA ``x`` launches a kernel, or raises; it never falls back. A CPU
    ``x`` runs the matching plain version. ``folded`` (from
    :func:`fold_constants` on ``x``'s device) saves refolding per call.

    ``input_mode="raw"`` (default) hands the kernel the samples, and it
    rebuilds the overlapping windows in shared memory; ``"frames"``
    pre-gathers the hop-strided windows into a ``[F, window]`` matrix first
    and the kernel reads its rows. ``fast`` / ``split`` (True, ``"conv"`` or
    4) choose a precision tier (:data:`TIERS`), as in the JAX function.
    ``packed`` is the JAX package's TPU lane layout of the DFT matrix (re
    and im in one 128-lane block); it is accepted and changes nothing here.
    """
    global LAUNCHES, FRAMES_LAUNCHES
    tier = _tier_of(fast, split)
    if input_mode not in ("raw", "frames"):
        raise ValueError(f"unknown input_mode {input_mode!r}")
    if folded is None:
        folded = fold_constants(spec, params, x.device)
    if x.dim() != 1:
        raise ValueError(f"expected samples of shape [n], got {tuple(x.shape)}")
    n_evals = _n_evals(spec, x.shape[0])
    if n_evals == 0:
        return x.new_zeros((0, spec.net.outputs))
    if input_mode == "frames":
        frames = frame_signal(
            x, n_evals + spec.time_range - 1, spec.window_length, spec.window_overlap
        ).contiguous()
        if x.device.type == "cpu":
            return fused_frames_outputs_reference(spec, folded, frames, tier)
        _check_launchable(x, folded, 1)
        out = _launch(spec, folded, frames[None], n_evals, tier=tier, frames_input=True)[0]
        FRAMES_LAUNCHES += 1
    else:
        if x.device.type == "cpu":
            return fused_batch_outputs_reference(spec, folded, x[None], tier=tier)[0]
        _check_launchable(x, folded, 1)
        out = _launch(spec, folded, x[None], n_evals, tier=tier)[0]
        if tier is None:
            LAUNCHES += 1
    if tier is not None:
        TIER_LAUNCHES[tier] += 1
    return out


def _distinct(params) -> bool:
    return isinstance(params, (list, tuple))


def _fold_for(spec: DetectorSpec, params, device) -> FusedOperands:
    if _distinct(params):
        return fold_constants_stacked(spec, params, device)
    return fold_constants(spec, params, device)


def _batch_evals(spec: DetectorSpec, params, xs: torch.Tensor, n_evals) -> int:
    """Check a ``[C, n]`` batch against its nets and the requested
    evaluation count (the JAX functions' contract); returns the count."""
    c, n = xs.shape
    if _distinct(params) and len(params) != c:
        raise ValueError(f"{len(params)} per-channel networks for {c} channels")
    max_evals = _n_evals(spec, n)
    if n_evals is None:
        return max_evals
    if n_evals > max_evals:
        raise ValueError(f"n_evals={n_evals} needs more than {n} samples")
    return n_evals


def fused_flat_batch_offline_outputs(
    spec: DetectorSpec,
    params,
    xs: torch.Tensor,
    n_evals: int | None = None,
    folded: FusedOperands | None = None,
) -> torch.Tensor:
    """``[C, n]`` float32 streams -> ``[C, E, outputs]`` through the kernel:
    ``params`` is one shared net (a params dict) or a sequence of C
    distinct nets of one geometry. ``n_evals`` beyond what ``n`` samples
    hold raises, as the JAX function's grid contract does; an unfusable
    spec runs the unfused path over every channel instead. ``folded`` (from
    :func:`fold_constants` or :func:`fold_constants_stacked` on ``xs``'s
    device) saves refolding per call.

    The JAX function's other input forms (flat 1-D and pre-slabbed 2-D) and
    its ``tile``/``hops_per_row``/``out_t`` layouts exist for the TPU's
    128-lane tiling; here ``[C, n]`` is already the kernel's layout.
    """
    global BATCH_LAUNCHES
    c = xs.shape[0]
    n_evals = _batch_evals(spec, params, xs, n_evals)
    if not fusable(spec):
        from syllable_detector_tpu_torch.models.detector import offline_outputs_batch

        return offline_outputs_batch(spec, params, xs)[:, :n_evals]
    if folded is None:
        folded = _fold_for(spec, params, xs.device)
    if n_evals <= 0:
        return xs.new_zeros((c, 0, spec.net.outputs), dtype=torch.float32)
    if xs.device.type == "cpu":
        return fused_batch_outputs_reference(spec, folded, xs, n_evals=n_evals)
    _check_launchable(xs, folded, c)
    out = _launch(spec, folded, xs, n_evals)
    BATCH_LAUNCHES += 1
    return out


def fused_batch_offline_outputs(
    spec: DetectorSpec,
    params,
    xs: torch.Tensor,
    tile: int | None = None,
    fast: bool = False,
    split=None,
    packed: bool | None = None,
    n_evals: int | None = None,
    slab_channels: int | None = 64,
    layout: str = "flat",
    folded: FusedOperands | None = None,
) -> torch.Tensor:
    """``[C, n]`` streams -> ``[C, E, outputs]``, shared or distinct nets.

    Routed as the JAX function routes it: ``layout="flat"`` (default) with
    no tier goes through :func:`fused_flat_batch_offline_outputs`, one
    launch over all lanes. ``layout="grid"``, or any precision tier
    (``fast`` / ``split``, :data:`TIERS`), takes the slabbed channel grid:
    ``C`` above ``slab_channels`` runs as one launch per slab of that many
    lanes (the last one shorter), each over its lanes' streams and, for
    distinct nets, their operands, all on the current stream with no host
    synchronisation between them. A slab is a pointer offset into ``xs``,
    the stacked operands and the output, so nothing is copied or padded.
    ``slab_channels=None`` is one launch.

    ``packed`` is the JAX package's TPU lane layout; it is accepted and
    changes nothing. ``tile`` is the kernels' own choice and is ignored.
    ``folded`` saves refolding per call.
    """
    global GRID_LAUNCHES
    tier = _tier_of(fast, split)
    if layout not in ("flat", "grid"):
        raise ValueError(f"unknown layout {layout!r}")
    if (layout == "flat" and tier is None) or not fusable(spec):
        return fused_flat_batch_offline_outputs(
            spec, params, xs, n_evals=n_evals, folded=folded
        )
    c = xs.shape[0]
    n_evals = _batch_evals(spec, params, xs, n_evals)
    if folded is None:
        folded = _fold_for(spec, params, xs.device)
    if n_evals <= 0:
        return xs.new_zeros((c, 0, spec.net.outputs), dtype=torch.float32)
    if xs.device.type == "cpu":
        return fused_batch_outputs_reference(spec, folded, xs, n_evals=n_evals, tier=tier)
    _check_launchable(xs, folded, c)
    out = torch.empty((c, n_evals, spec.net.outputs), dtype=torch.float32, device=xs.device)
    slab = c if slab_channels is None else slab_channels
    for lane0 in range(0, c, slab):
        _launch(spec, folded, xs, n_evals, tier=tier, lane0=lane0,
                lanes=min(slab, c - lane0), out=out)
        GRID_LAUNCHES += 1
        if tier is not None:
            TIER_LAUNCHES[tier] += 1
    return out


class BatchProgram:
    """One live drain round for a fixed ``[lanes, n]`` wire shape:
    :meth:`upload` (one host->device copy of the wire samples, asynchronous
    from pinned memory), :meth:`launch` (ONE kernel launch, the wire
    dequantised inside it) and the device->host copy of the outputs.
    Calling it runs all three: ``fn(xs_wire[lanes, n]) -> np.ndarray
    [lanes, n_evals, outputs]``. On a CPU device the launch is the plain
    version, :func:`fused_batch_outputs_reference`."""

    def __init__(self, spec, folded, lanes, n, n_evals, wire, device):
        self.spec = spec
        self.folded = folded
        self.shape = (lanes, n)
        self.n_evals = n_evals
        self.wire = wire
        self.device = torch.device(device)
        self.dtype = WIRE_DTYPES[wire]

    def upload(self, xs) -> torch.Tensor:
        xs = torch.as_tensor(xs)
        if tuple(xs.shape) != self.shape or xs.dtype != self.dtype:
            raise ValueError(
                f"this program takes {self.wire} samples of shape {self.shape}, "
                f"got {xs.dtype} of shape {tuple(xs.shape)}"
            )
        return xs.to(self.device, non_blocking=xs.is_pinned())

    def launch(self, xd: torch.Tensor) -> torch.Tensor:
        if xd.device.type == "cpu":
            return fused_batch_outputs_reference(
                self.spec, self.folded, xd, self.wire, self.n_evals
            )
        if self.wire == "float32":
            return fused_flat_batch_offline_outputs(
                self.spec, None, xd, n_evals=self.n_evals, folded=self.folded
            )
        _check_launchable(xd, self.folded, self.shape[0])
        out = _launch(self.spec, self.folded, xd, self.n_evals, self.wire)
        PROGRAM_LAUNCHES[self.wire] += 1
        return out

    def __call__(self, xs) -> np.ndarray:
        return self.launch(self.upload(xs)).cpu().numpy()


def fused_batch_program(
    spec: DetectorSpec, params, n: int, wire_dtype: str = "float32", device="cuda"
) -> BatchProgram | None:
    """Build the drain program of the live bank path for ``len(params)``
    lanes of ``n`` wire samples each (``params``: the bank's per-lane nets,
    folded once here). Returns None when the spec is unfusable or ``n``
    holds no evaluation, where callers keep the unfused path, as the JAX
    function does."""
    if not _distinct(params):
        raise ValueError("fused_batch_program needs the per-lane params list")
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    if not fusable(spec):
        return None
    n_evals = _n_evals(spec, n)
    if n_evals <= 0:
        return None
    folded = fold_constants_stacked(spec, list(params), device)
    return BatchProgram(spec, folded, len(params), n, n_evals, wire_dtype, device)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sd_fused_detector.argtypes = (
        [p, i, i, ll, ll, ll] + [p] * 7 + [i] * 10 + [p, p, f, f, f, i, p]
    )
    lib.sd_fused_detector.restype = i
    lib.sd_fused_detector_smem_bytes.argtypes = [i] * 7
    lib.sd_fused_detector_smem_bytes.restype = ll
    lib.sd_max_layers.argtypes = []
    lib.sd_max_layers.restype = i
    lib.sd_error_string.argtypes = [i]
    lib.sd_error_string.restype = ctypes.c_char_p
    return lib


def _bind_tiers(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sd_fused_tiers.argtypes = (
        [p, i, i, ll, ll, ll] + [p] * 11 + [i] * 12 + [p, p, i, p]
    )
    lib.sd_fused_tiers.restype = i
    lib.sd_fused_tiers_smem_bytes.argtypes = [i] * 11
    lib.sd_fused_tiers_smem_bytes.restype = ll
    lib.sd_tiers_max_layers.argtypes = []
    lib.sd_tiers_max_layers.restype = i
    lib.sd_tiers_error_string.argtypes = [i]
    lib.sd_tiers_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound fp32 kernel library (built at the first launch)."""
    from syllable_detector_tpu_torch.kernels import _build

    return _bind(_build.load("fused_detector"))


@functools.cache
def _tiers_library() -> ctypes.CDLL:
    """The built and bound tier and frames-input kernel library."""
    from syllable_detector_tpu_torch.kernels import _build

    return _bind_tiers(_build.load("fused_detector_tiers"))


def _tile(n_evals: int) -> int:
    """Evaluations per CTA: TILE, cut down for small drains as the JAX
    program cuts its flat tile (``min(tile, max(8, round_up(E, 8)))``), so
    that a bucket of 8 does not leave three quarters of each CTA idle."""
    return min(TILE, max(8, _round_up(n_evals, 8)))


def _tiers_tile(spec: DetectorSpec, n_evals: int) -> int:
    """Evaluations per CTA of the tier kernel: :func:`_tile` raised until
    the tile's ``tile + timeRange - 1`` frames fill whole 16-row tensor-core
    fragments (39 at the sample geometry: 48 frames)."""
    halo = spec.time_range - 1
    return _round_up(_tile(n_evals) + halo, FRAG) - halo


def _check_launchable(x: torch.Tensor, folded: FusedOperands, lanes: int) -> None:
    """Raise unless ``x`` lies on a Hopper card with ``folded`` beside it."""
    if x.device.type != "cuda":
        raise ValueError(f"no fused detector kernel for device {x.device}")
    operands = (folded.c, folded.w1, folded.c1, folded.mids_flat,
                folded.out_a, folded.out_c)
    if any(o.device != x.device for o in operands):
        raise ValueError("folded operands and samples lie on different devices")
    if folded.per_lane and folded.w1.shape[0] != lanes:
        raise ValueError(
            f"{folded.w1.shape[0]} per-lane networks for {lanes} lanes"
        )
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(
            "the fused kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(x.device)} is not"
        )


def _launch(
    spec: DetectorSpec,
    folded: FusedOperands,
    xs: torch.Tensor,
    n_evals: int,
    wire: str = "float32",
    tier: str | None = None,
    frames_input: bool = False,
    lane0: int = 0,
    lanes: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One launch over lanes ``[lane0, lane0 + lanes)`` of ``xs`` (on the
    card: ``[C, n]`` samples of the wire's type or, with ``frames_input``,
    ``[C, F, window]`` float32 frames) into the same lanes of ``out``
    ``[C, n_evals, outputs]`` float32 (allocated when None), which it
    returns. The lanes' slice of every operand is a pointer offset. A
    ``tier`` or ``frames_input`` launches the kernel of
    ``csrc/fused_detector_tiers.cu``, else that of ``csrc/fused_detector.cu``.
    """
    c, n = xs.shape[:2]
    lanes = c - lane0 if lanes is None else lanes
    want = (3, spec.window_length) if frames_input else (2, n)
    if (
        xs.dtype != WIRE_DTYPES[wire]
        or not xs.is_contiguous()
        or (xs.dim(), xs.shape[-1]) != want
        or not 0 <= lane0 < lane0 + lanes <= c
    ):
        raise ValueError(
            f"the fused kernel takes a contiguous [lanes, n] {wire} tensor (or "
            f"[lanes, F, window] frames), got {xs.dtype} of shape {tuple(xs.shape)}"
        )
    tiered = tier is not None or frames_input
    if tiered and wire != "float32":
        raise ValueError("the tier and frames-input kernel reads float32 only")
    lib = _tiers_library() if tiered else _library()
    max_layers = lib.sd_tiers_max_layers() if tiered else lib.sd_max_layers()
    widths = [w for _, w in spec.net.layer_sizes]
    if len(widths) > max_layers:
        raise ValueError(f"the fused kernel takes at most {max_layers} layers")
    gap, _ = normalize_overlap(spec.window_overlap)
    geometry = (spec.window_length, spec.hop, gap, spec.n_bins, spec.time_range)
    dft_passes, conv_passes = TIERS[tier] if tier else (0, 0)
    if tiered:
        tile = _tiers_tile(spec, n_evals)
        smem = lib.sd_fused_tiers_smem_bytes(
            *geometry, tile, max(widths), widths[0], int(frames_input),
            dft_passes, conv_passes,
        )
    else:
        tile = _tile(n_evals)
        smem = lib.sd_fused_detector_smem_bytes(*geometry, tile, max(widths))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the fused kernel needs {smem} bytes of shared memory per CTA "
            f"at this geometry; the card offers {SMEM_LIMIT}"
        )
    if out is None:
        out = torch.empty(
            (c, n_evals, spec.net.outputs), dtype=torch.float32, device=xs.device
        )
    elif (
        out.shape != (c, n_evals, spec.net.outputs)
        or out.dtype != torch.float32
        or out.device != xs.device
        or not out.is_contiguous()
    ):
        raise ValueError(f"unexpected output tensor of shape {tuple(out.shape)}")
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_transfers = (ctypes.c_int * len(widths))(
        *(TRANSFER_CODES[t] for t in spec.net.transfers)
    )

    def at(t: torch.Tensor, per_net: bool = True) -> int:
        """``t``'s address at lane ``lane0``: ``xs`` and ``out`` have a lane
        axis, a net operand only when the nets are per lane."""
        if per_net and not folded.per_lane:
            return t.data_ptr()
        return t.data_ptr() + lane0 * t.stride(0) * t.element_size()

    ld = xs.stride(0)
    device = xs.device.index if xs.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    net_ptrs = (at(folded.c1), at(folded.mids_flat), at(folded.out_a),
                at(folded.out_c), at(out, False), int(folded.per_lane))
    tail = (len(widths), c_widths, c_transfers)
    if tiered:
        c_hi, c_lo, w1g_hi, w1g_lo = folded.tiers
        err = lib.sd_fused_tiers(
            at(xs, False), int(frames_input), lanes, ld, n, n_evals,
            folded.c.data_ptr(), c_hi.data_ptr(), c_lo.data_ptr(), at(folded.w1),
            at(w1g_hi), at(w1g_lo), *net_ptrs,
            *geometry, SCALING_CODES[spec.scaling], int(folded.has_l2), tile,
            dft_passes, conv_passes, *tail, device, stream,
        )
        message = lib.sd_tiers_error_string
    else:
        scale = MULAW_INV127 if wire == "mulaw8" else INT16_SCALE
        err = lib.sd_fused_detector(
            at(xs, False), WIRE_CODES[wire], lanes, ld, n, n_evals,
            folded.c.data_ptr(), at(folded.w1), *net_ptrs,
            *geometry, SCALING_CODES[spec.scaling], int(folded.has_l2), tile,
            *tail, float(scale), float(MULAW_LN1MU), float(MULAW_INV_MU),
            device, stream,
        )
        message = lib.sd_error_string
    if err != 0:
        raise RuntimeError(
            "fused detector kernel launch failed: "
            f"{message(err).decode()} (cudaError {err})"
        )
    return out
