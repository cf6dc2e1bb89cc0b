"""Fused STFT + feature + MLP detection: the CUDA kernel and its plain versions.

Replaces the JAX package's Pallas kernel (``kernels/fused_detector.py``,
``_fused_call`` / ``_make_kernel``) on every path that reaches it, all
through the kernel of ``csrc/fused_detector.cu``: one stream
(``fused_offline_outputs``), a ``[C, n]`` batch with a shared net or one net
per channel (``fused_flat_batch_offline_outputs``,
``fused_batch_offline_outputs``), the live drain program that reads that
batch from an int16 or mu-law wire (``fused_batch_program``), the precision
tiers (``fast=`` / ``split=``: the two big GEMMs as 1, 3 or 4 bf16 products
on the tensor cores, :data:`TIERS`) and the pre-gathered frames input
(``input_mode="frames"``). ``layout="grid"`` runs it over slabs of
``slab_channels`` lanes, one launch per slab. The algebra:

  * window multiply + zero-pad + DFT + band slice fold into one
    ``[window, 2*bins]`` matrix C (re | im);
  * the first layer over the stacked feature vector is a T-tap convolution
    over the frame axis, with the affine input chain (mapminmax / mapstd)
    folded into its weights and bias; the feature matrix is never built;
  * l2normalize needs only the sliding sum of per-frame row sums of squares;
  * the output chain's reverse mapping is one affine after the last layer.

:func:`fold_constants` computes those operands in float64 and casts them
once (:func:`fold_constants_stacked` for one net per channel).

The kernel runs the band DFT on the tensor cores (``wgmma``, A from
registers). In full fp32 it is three TF32 products of split operands
(``a_lo @ c_hi + a_hi @ c_lo + a_hi @ c_hi``, accumulated in fp32), which
keeps fp32 accuracy (about 1e-6 relative; the counterpart of
``Precision.HIGHEST``'s bf16 passes on the TPU); under a tier it is the
tier's bf16 products of the JAX kernel's hi/lo halves, and so is the first
layer's conv filter-bank GEMM; where T*h1 is wide (:func:`tc_first_layer`)
the fp32 first layer is that GEMM too, in three TF32 products. The fold
splits C once and lays it out as the tensor cores read it
(:func:`tile_dft_matrix` in TF32, :func:`tile_dft_matrix_bf16` in bf16,
from :func:`pad_dft_matrix`: columns permuted into 8-column re and im
tiles, zero-padded), and the conv filter bank likewise
(:func:`tile_conv_bank_bf16`, :func:`tile_conv_bank_tf32`); the kernel
splits the samples as it loads them; :func:`split_dft_reference` is the
TF32 arithmetic in plain PyTorch. A
CTA transforms ``frames`` frames for ``frames - timeRange + 1``
evaluations; :func:`cta_choice` picks ``frames`` from the launch shape (64
for a live bucket on many lanes, 128 for long lanes) and the shared-memory
layout from the geometry, and :func:`smem_bytes` is the shared memory it
needs. Three layouts (:data:`LAYOUTS`), tried in order: the resident one
holds a CTA's whole working set (the sample span, every column chunk of C,
a bf16 first layer's whole product and bank) and is taken wherever it
fits, the sample geometry's every path among them; the span layout, for
CTAs of 128 frames or more, keeps the span resident and streams C over
groups of column chunks (and a bf16 first layer one chunk at a time); the
streamed layout also stages A one
k-block at a time, and fits every geometry of :data:`ENVELOPE` (fft up to
1024 over any band, window, overlap or gap; timeRange up to 32; layers up
to 256 wide; any depth), on every entry, wire, input form, tier and net
form. All three give the same outputs bit for bit. Outside the envelope a
geometry may still fit; one that does not raises, naming the envelope. Each
entry launches the kernel for a CUDA tensor, raising rather than falling
back, and runs its plain PyTorch version
(:func:`fused_offline_outputs_reference`,
:func:`fused_batch_outputs_reference`,
:func:`fused_tier_outputs_reference`,
:func:`fused_frames_outputs_reference`) for a CPU tensor. Launches are
counted per entry: :data:`LAUNCHES` (one stream), :data:`BATCH_LAUNCHES`
(float32 batches, the float32 wire included), :data:`PROGRAM_LAUNCHES` (the
dequantising wires), :data:`TIER_LAUNCHES` (per precision tier),
:data:`FRAMES_LAUNCHES` (frames input) and :data:`GRID_LAUNCHES` (slabs of
the grid layout), and per layout in :data:`LAYOUT_LAUNCHES`.
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
    "LAYOUT_LAUNCHES",
    "ENVELOPE",
    "LAYOUTS",
    "CtaChoice",
    "cta_choice",
    "col_group_for",
    "round_chunks",
    "TIERS",
    "WIRE_DTYPES",
    "FusedOperands",
    "BatchProgram",
    "fusable",
    "fold_constants",
    "fold_constants_stacked",
    "pad_dft_matrix",
    "tile_dft_matrix",
    "tile_dft_matrix_bf16",
    "tile_conv_bank_bf16",
    "split_operands",
    "split_dft_reference",
    "tc_first_layer",
    "tile_conv_bank_tf32",
    "cta_frames",
    "smem_bytes",
    "stage_shares",
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

# Frames one CTA of the kernel may transform (multiples of the 64 rows of a
# wgmma tile); it serves frames - timeRange + 1 evaluations.
CTA_FRAMES = (64, 128)
# The kernel's staging of C: rows per shared-memory stage (TF32; bf16 has
# twice the rows in the same bytes), stages, and the bins of one column tile
# (csrc/fused_detector.cu).
DFT_BLOCK_ROWS = 16
DFT_BF16_BLOCK_ROWS = 32
DFT_STAGES = 3
DFT_GROUP_BINS = 8
# Columns of one wgmma tile: 4 bin groups, re and im.
DFT_UNIT_COLS = 64
# Rows of one bf16 k-step, and the order in which the kernel's A fragment
# holds them (pack_bf16_step in csrc/fused_detector.cu): fragment column
# 8h + 2t is row 8h + t of the k-step and 8h + 2t + 1 is row 8h + t + 4, so
# that a thread loads the columns it loads for two TF32 k-steps of 8. The
# bf16 tiles store B's rows in this order; a sum over k does not change.
BF16_STEP_ROWS = 16
BF16_STEP_ORDER = tuple(8 * (p // 8) + (p % 8) // 2 + 4 * (p % 2) for p in range(16))
# An H100's SMs (for choosing a tile where no card can be asked), the shared
# memory and registers of one, and the registers a thread of the kernel
# takes at most in each layout, the resident one with its fp32 first layer
# on the CUDA or the tensor cores (ptxas on an H100 build, CUDA 12.8:
# 75-109, 117-121, 111-149 and 127-200; chip_smoke.py phase 2 holds every
# instantiation to its figure). A thread holds registers in eights, so 121
# takes 128: two CTAs of 256 threads an SM either way in the resident
# layout, one in the others.
H100_SMS = 132
SM_SMEM = 233472
SM_REGISTERS = 65536
KERNEL_REGISTERS = {"resident": 120, "resident tc": 128, "span": 152, "streamed": 200}
# Dynamic shared memory one CTA may opt in to on Hopper (227 KB).
SMEM_LIMIT = 232448
# Floats past a k-block's rows between two staged frames of the streamed
# layout, the row stride of the chunked first layer's product, and the
# stages of its bank ring in the streamed layout (csrc/fused_detector.cu
# kRowPad, kProdLd, kConvRingStreamed).
STREAM_ROW_PAD = 4
PROD_LD = DFT_UNIT_COLS + 8
CONV_RING_STREAMED = 2
# The streamed layout's stages of C and of A (csrc/fused_detector.cu
# kStreamStages, kAStages).
STREAM_STAGES = 4
A_STAGES = 3
# conv_passes of the fp32 first layer on the tensor cores (three TF32
# products of split operands, csrc/fused_detector.cu kConvTf32), its rows
# per k-step, and the T*h1 from which the kernel takes it over its CUDA-core
# first layer (chip_smoke.py phase 22 times both).
CONV_TF32 = -3
TF32_STEP_ROWS = 8
TC_FIRST_LAYER_COLS = 160
# The geometries every entry takes on the card, each wire, input form, tier
# and net form (cta_choice: the resident layout where it fits, else the
# streamed one, which fits every geometry inside; a geometry outside may
# still fit, and one that does not raises naming this).
ENVELOPE = (
    "every fusable spec with fft <= 1024 (any band, window, overlap or gap), "
    "timeRange <= 32, every layer <= 256 wide and any depth"
)

SCALING_CODES = {"linear": 0, "log": 1, "db": 2}
TRANSFER_CODES = {"PureLin": 0, "TanSig": 1, "LogSig": 2, "SatLin": 3}
DB_PER_NEPER = np.float32(20.0 / np.log(10.0))

# Kernel launches in this process, per entry; reset them to 0 before a run
# whose launches are to be counted. LAUNCHES: fused_offline_outputs (one
# stream). BATCH_LAUNCHES: fused_flat_batch_offline_outputs (float32
# [C, n], also reached through fused_batch_offline_outputs and a float32
# fused_batch_program). PROGRAM_LAUNCHES: fused_batch_program per
# dequantising wire. TIER_LAUNCHES: launches under each precision tier, from
# any entry. FRAMES_LAUNCHES: fused_offline_outputs with
# input_mode="frames". GRID_LAUNCHES: slab launches of the grid layout
# (fused_batch_offline_outputs with layout="grid" or a tier).
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
# Launches per shared-memory layout (CtaChoice.layout), from any entry.
LAYOUT_LAUNCHES = {"resident": 0, "span": 0, "streamed": 0}
# bf16 k-step: split_operands pads the untiled halves to it
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
    # c split into TF32 halves in the kernel's layout, see tile_dft_matrix
    c_tiled: torch.Tensor | None = None
    # for the precision tiers: c and the first layer's conv filter bank (per
    # lane with per-lane nets) split into bf16 halves in the kernel's
    # layout, see tile_dft_matrix_bf16 and tile_conv_bank_bf16
    c_bf16: torch.Tensor | None = None
    w1g_bf16: torch.Tensor | None = None
    # for the fp32 first layer on the tensor cores (tc_first_layer): the
    # conv filter bank split into TF32 halves, see tile_conv_bank_tf32
    w1g_tf32: torch.Tensor | None = None


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
        c_tiled=tile_dft_matrix(c_t),
        c_bf16=tile_dft_matrix_bf16(c_t),
        w1g_bf16=tile_conv_bank_bf16(w1_t),
        w1g_tf32=tile_conv_bank_tf32(w1_t) if tc_first_layer(spec) else None,
    )


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: the bit pattern
    plus half a unit of the last kept place, the 13 low bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_hi_lo(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` as two TF32 halves: ``hi = tf32(t)``, ``lo = tf32(t - hi)``."""
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _tile_columns(bins: int, device) -> torch.Tensor:
    """Column of re of each bin in the kernel's layout: tiles of 8, tile
    ``2j`` re of bins ``8j .. 8j+7`` and tile ``2j+1`` their im (8 further)."""
    k = torch.arange(bins, device=device)
    return (k // DFT_GROUP_BINS) * 2 * DFT_GROUP_BINS + k % DFT_GROUP_BINS


def pad_dft_matrix(c: torch.Tensor, block_rows: int = DFT_BLOCK_ROWS) -> torch.Tensor:
    """The folded ``c`` [window, 2*bins] (re | im) with its columns in the
    kernel's tiles of 8 (tile ``2j`` re of bins ``8j .. 8j+7``, tile
    ``2j+1`` their im), zero-padded to whole :data:`DFT_UNIT_COLS` columns
    and ``block_rows`` rows: ``[rows, cols]`` float32. A padded column or
    row adds nothing."""
    window, two_b = c.shape
    b = two_b // 2
    col = _tile_columns(b, c.device)
    cols = _round_up(2 * DFT_GROUP_BINS * -(-b // DFT_GROUP_BINS), DFT_UNIT_COLS)
    padded = c.new_zeros((_round_up(window, block_rows), cols))
    padded[:window, col] = c[:, :b]
    padded[:window, col + DFT_GROUP_BINS] = c[:, b:]
    return padded


def tile_dft_matrix(c: torch.Tensor) -> torch.Tensor:
    """The kernel's full-fp32 DFT operand from the folded ``c``: the padded
    matrix of :func:`pad_dft_matrix` split into TF32 halves and laid out as
    the tensor cores read it from shared memory, so that a row block is one
    contiguous copy: ``[blocks, 2 (hi, lo), steps, chunks, 8, 2, 8, 4]`` =
    blocks of :data:`DFT_BLOCK_ROWS` rows x halves x k-steps of 8 rows x
    chunks of 64 columns x blocks of 8 columns x halves of a k-step x
    column x row."""
    padded = pad_dft_matrix(c)
    rows, cols = padded.shape
    halves = torch.stack(_tf32_hi_lo(padded))  # [2, rows, cols]
    steps = DFT_BLOCK_ROWS // 8
    t = halves.reshape(2, rows // DFT_BLOCK_ROWS, steps, 2, 4, cols // DFT_UNIT_COLS, 8, 8)
    # (half, block, step, k half, k, chunk, column block, column)
    return t.permute(1, 0, 2, 5, 6, 3, 7, 4).contiguous()


def _tile_bf16(padded: torch.Tensor, steps_per_block: int) -> torch.Tensor:
    """``padded`` [rows, cols] float32 (rows a multiple of 16 x
    ``steps_per_block``, cols of 64) split into bf16 halves and laid out as
    the kernel's bf16 wgmma reads B from shared memory: ``[blocks, 2 (hi,
    lo), steps, chunks, 8, 2, 8, 8]`` = blocks of ``steps_per_block``
    k-steps x halves x k-steps of 16 rows x chunks of 64 columns x blocks of
    8 columns x halves of a k-step x column x row, each k-step's rows in
    :data:`BF16_STEP_ORDER`."""
    rows, cols = padded.shape
    halves = torch.stack(_hi_lo(padded))  # [2, rows, cols]
    order = torch.tensor(BF16_STEP_ORDER, device=padded.device)
    steps = halves.reshape(2, rows // BF16_STEP_ROWS, BF16_STEP_ROWS, cols)[:, :, order]
    t = steps.reshape(2, rows // (BF16_STEP_ROWS * steps_per_block), steps_per_block, 2, 8,
                      cols // DFT_UNIT_COLS, 8, 8)
    # (half, block, step, k half, k, chunk, column block, column)
    return t.permute(1, 0, 2, 5, 6, 3, 7, 4).contiguous()


def tile_dft_matrix_bf16(c: torch.Tensor) -> torch.Tensor:
    """The kernel's DFT operand under a precision tier: the padded matrix of
    :func:`pad_dft_matrix` (rows to whole :data:`DFT_BF16_BLOCK_ROWS`)
    split into the JAX kernel's bf16 halves (``hi = bf16(c)``, ``lo =
    bf16(c - hi)``) and tiled as :func:`_tile_bf16` says, two k-steps of 16
    a row block, so that a row block is one contiguous copy of the same
    bytes as a TF32 block: ``[blocks, 2, 2, chunks, 8, 2, 8, 8]``
    bfloat16."""
    return _tile_bf16(pad_dft_matrix(c, DFT_BF16_BLOCK_ROWS),
                      DFT_BF16_BLOCK_ROWS // BF16_STEP_ROWS)


def tile_conv_bank_bf16(w1: torch.Tensor) -> torch.Tensor:
    """The kernel's first-layer operand under a precision tier, from one
    net's folded ``w1`` [T, bins, h1]: the conv filter bank ``w1g[k, t*h1 +
    j] = w1[t, k, j]``, zero-padded to whole k-steps of 16 bins and chunks
    of 64 columns, split into bf16 halves and tiled as :func:`_tile_bf16`
    says, one k-step a block: ``[2 (hi, lo), steps, chunks, 8, 2, 8, 8]``
    bfloat16 (the block axis folded into the steps)."""
    t_range, b, h1 = w1.shape
    bank = w1.transpose(0, 1).reshape(b, t_range * h1)
    padded = w1.new_zeros((_round_up(b, BF16_STEP_ROWS), _round_up(t_range * h1, DFT_UNIT_COLS)))
    padded[:b, : t_range * h1] = bank
    tiled = _tile_bf16(padded, 1)  # [steps, 2, 1, chunks, 8, 2, 8, 8]
    return tiled.squeeze(2).transpose(0, 1).contiguous()


def tc_first_layer(spec: DetectorSpec) -> bool:
    """Whether the kernel computes the fp32 first layer on the tensor cores
    (the conv filter-bank GEMM in three TF32 products, chunk by chunk, as
    the tiers compute theirs) rather than as dot products on the CUDA
    cores: where T*h1 is at least :data:`TC_FIRST_LAYER_COLS`. The sample
    net (T*h1 = 40) keeps the CUDA cores."""
    return spec.time_range * spec.net.layer_sizes[0][1] >= TC_FIRST_LAYER_COLS


def _conv_bank(w1: torch.Tensor) -> torch.Tensor:
    """The conv filter bank ``w1g[k, t*h1 + j] = w1[t, k, j]`` of a folded
    ``w1`` [..., T, bins, h1]: ``[..., bins, T*h1]``."""
    t_range, b, h1 = w1.shape[-3:]
    return w1.transpose(-3, -2).reshape(*w1.shape[:-3], b, t_range * h1)


def tile_conv_bank_tf32(w1: torch.Tensor) -> torch.Tensor:
    """The kernel's operand for the fp32 first layer on the tensor cores,
    from one net's folded ``w1`` [T, bins, h1]: the conv filter bank
    zero-padded to whole k-steps of 8 bins and chunks of 64 columns, split
    into TF32 halves and tiled as one k-step of C is
    (:func:`tile_dft_matrix`): ``[2 (hi, lo), steps, chunks, 8, 2, 8, 4]`` =
    halves x k-steps of 8 rows x chunks of 64 columns x blocks of 8 columns
    x halves of a k-step x column x row."""
    t_range, b, h1 = w1.shape
    padded = w1.new_zeros((_round_up(b, TF32_STEP_ROWS), _round_up(t_range * h1, DFT_UNIT_COLS)))
    padded[:b, : t_range * h1] = _conv_bank(w1)
    rows, cols = padded.shape
    halves = torch.stack(_tf32_hi_lo(padded))  # [2, rows, cols]
    t = halves.reshape(2, rows // 8, 2, 4, cols // DFT_UNIT_COLS, 8, 8)
    # (half, step, k half, k, chunk, column block, column)
    return t.permute(0, 1, 4, 5, 2, 6, 3).contiguous()


def split_dft_reference(frames: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel's full-fp32 band DFT in plain PyTorch: ``[..., window]`` frames
    and the folded ``c`` [window, 2*bins] -> ``[..., 2*bins]`` (re | im) as
    the three TF32 products of the split operands (``hi = tf32(v)``, ``lo =
    tf32(v - hi)``), small terms first, through the padded layout. The
    halves are exact in float32, so each product is a float32 matmul of
    them; the tensor cores sum in another order, to the same accuracy."""
    window, bins = c.shape[0], c.shape[1] // 2
    c_hi, c_lo = _tf32_hi_lo(pad_dft_matrix(c)[:window])
    a_hi, a_lo = _tf32_hi_lo(frames)
    big = a_lo @ c_hi + a_hi @ c_lo + a_hi @ c_hi
    col = _tile_columns(bins, frames.device)
    return torch.cat([big[..., col], big[..., col + DFT_GROUP_BINS]], dim=-1)


def _hi_lo(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` as two bfloat16 halves, rounded to nearest even: ``hi =
    bf16(t)``, ``lo = bf16(t - f32(hi))``, the JAX kernel's ``hi_lo``."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.to(torch.float32)).to(torch.bfloat16)


def split_operands(c: torch.Tensor, w1: torch.Tensor) -> tuple:
    """The precision tiers' bf16 operands (c_hi, c_lo, w1g_hi, w1g_lo) of
    one net, untiled, from its folded ``c`` [window, 2*bins] and ``w1`` [T,
    bins, h1]: the JAX kernel's ``hi_lo`` halves of C and of the conv filter
    bank ``w1g[k, t*h1 + j] = w1[t, k, j]`` (one GEMM over the bins computes
    all T taps), every extent padded with zeros to a multiple of 16. The
    kernel reads the same values tiled (:func:`tile_dft_matrix_bf16`,
    :func:`tile_conv_bank_bf16`)."""
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
        c_tiled=f0.c_tiled.to(device),
        c_bf16=f0.c_bf16.to(device),
        w1g_bf16=stack(f.w1g_bf16 for f in folds),
        w1g_tf32=stack(f.w1g_tf32 for f in folds) if f0.w1g_tf32 is not None else None,
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
    """The kernel's full-fp32 plain PyTorch version for one stream: [n] ->
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
    """The kernel's plain PyTorch version under a tier: ``[L, n]`` float32 samples
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
    n_evals: int | None = None,
) -> torch.Tensor:
    """Whole-signal detection through a fused kernel: [n] -> [E, outputs].

    A CUDA ``x`` launches a kernel, or raises; it never falls back. A CPU
    ``x`` runs the matching plain version. ``folded`` (from
    :func:`fold_constants` on ``x``'s device) saves refolding per call.
    ``n_evals`` caps the evaluations (default: every one the ``n`` samples
    hold; more raises ``ValueError``). An unfusable spec runs the unfused
    path (:func:`~syllable_detector_tpu_torch.models.detector.offline_outputs`)
    under the same ``n_evals`` contract, as the JAX function does.

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
    if x.dim() != 1:
        raise ValueError(f"expected samples of shape [n], got {tuple(x.shape)}")
    max_evals = _n_evals(spec, x.shape[0])
    if n_evals is None:
        n_evals = max_evals
    elif n_evals > max_evals:
        raise ValueError(f"n_evals={n_evals} needs more than {x.shape[0]} samples")
    if not fusable(spec):
        from syllable_detector_tpu_torch.models.detector import offline_outputs

        return offline_outputs(spec, params, x)[: max(n_evals, 0)]
    if folded is None:
        folded = fold_constants(spec, params, x.device)
    if n_evals <= 0:
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
            return fused_batch_outputs_reference(
                spec, folded, x[None], n_evals=n_evals, tier=tier
            )[0]
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
        [p, i, i, ll, ll, ll] + [p] * 8 + [i] * 14 + [p, p, p, f, f, f, i, p]
    )
    lib.sd_fused_detector.restype = i
    lib.sd_fused_detector_smem_bytes.argtypes = [i] * 12
    lib.sd_fused_detector_smem_bytes.restype = ll
    lib.sd_fused_detector_c_blocks.argtypes = [i, i]
    lib.sd_fused_detector_c_blocks.restype = i
    lib.sd_fused_detector_c_chunks.argtypes = [i]
    lib.sd_fused_detector_c_chunks.restype = i
    lib.sd_fused_detector_conv_bank_floats.argtypes = [i, i, i]
    lib.sd_fused_detector_conv_bank_floats.restype = ll
    lib.sd_fused_detector_tf32_bank_floats.argtypes = [i, i, i]
    lib.sd_fused_detector_tf32_bank_floats.restype = ll
    lib.sd_fused_detector_set_profile.argtypes = [p]
    lib.sd_fused_detector_set_profile.restype = None
    lib.sd_error_string.argtypes = [i]
    lib.sd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound kernel library (built at the first launch)."""
    from syllable_detector_tpu_torch.kernels import _build

    return _bind(_build.load("fused_detector"))


def _dft_chunks(spec: DetectorSpec) -> int:
    """Chunks of :data:`DFT_UNIT_COLS` columns that hold the padded C."""
    return -(-2 * DFT_GROUP_BINS * -(-spec.n_bins // DFT_GROUP_BINS) // DFT_UNIT_COLS)


def _conv_passes(spec: DetectorSpec, tier: str | None, tc: bool | None = None) -> int:
    """The kernel's ``conv_passes``: a tier's bf16 products, else
    :data:`CONV_TF32` for the fp32 first layer on the tensor cores (``tc``,
    by default :func:`tc_first_layer`), else 0 for the CUDA cores."""
    if tier:
        return TIERS[tier][1]
    return CONV_TF32 if (tc_first_layer(spec) if tc is None else tc) else 0


def smem_bytes(spec: DetectorSpec, frames: int, max_width: int,
               tier: str | None = None, frames_input: bool = False,
               col_group: int = 0, tc: bool | None = None) -> int:
    """Dynamic shared memory of one CTA of the kernel that transforms
    ``frames`` frames under ``tier`` (a :data:`TIERS` key, None for full
    fp32), from samples or with ``frames_input`` from a frames matrix, in
    the layout ``col_group`` names (``smem_floats`` of
    ``csrc/fused_detector.cu``). ``tc`` forces the fp32 first layer onto the
    tensor cores or off them (default :func:`tc_first_layer`).

    The resident layout (``col_group`` 0): the sample span (or the frame
    rows at a stride of the window rounded up to 32, plus 4), the stages of
    C's row blocks (both halves), the spectrogram, its row sums and two
    activation buffers. Under a bf16 first layer the first region also
    holds that layer's product ([frames, 64 per chunk of T*h1 columns + 8])
    and the stages its tiled filter bank (both halves); under the fp32 one
    on the tensor cores the first region holds one chunk of its product
    ([frames, 72]) and the stages its bank ring.

    The span layout (``col_group`` -n, n chunks of C a pass over k): the
    span or frame rows (later one chunk of a chunked first layer's product,
    then the second activation buffer), the stages of C over n chunks, the
    spectrogram, the first activation buffer, the row sums and norms.

    The streamed layout (``col_group`` n): :data:`STREAM_STAGES` stages of C
    over n chunks (under a chunked first layer at least two k-steps of one
    chunk of its bank and that chunk's product [frames, 72]); the first
    activation buffer, or during the band DFT :data:`A_STAGES` k-blocks of
    A [frames, rows + 4] and the mu-law table; the spectrogram, or after
    the first layer the second activation buffer; the row sums and
    norms.

    A chunked first layer: the fp32 one on the tensor cores, or a bf16 one
    outside the resident layout."""
    dft_passes = TIERS[tier][0] if tier else 0
    conv_passes = _conv_passes(spec, tier, tc)
    step = 8 * DFT_UNIT_COLS  # floats of one k-step of one 64-column chunk
    tile = frames - spec.time_range + 1
    gap, _ = normalize_overlap(spec.window_overlap)
    window = spec.window_length
    if frames_input:
        rows = frames * (_round_up(window, 32) + 4)
    else:
        rows = _round_up((frames - 1) * spec.hop + gap + window, 4)
    chunked = conv_passes == CONV_TF32 or (conv_passes > 0 and col_group != 0)
    product = frames * PROD_LD if chunked else 0
    acts = _round_up(tile * max_width, 4)
    sums = _round_up(frames + tile, 4)
    stage = 2 * 2 * step * abs(col_group)  # one row block of C over a pass's chunks
    if col_group < 0:
        return 4 * (max(rows, acts, product) + DFT_STAGES * stage
                    + _round_up(frames * spec.n_bins, 4) + acts + sums)
    if col_group > 0:
        a_rows = DFT_BF16_BLOCK_ROWS if dft_passes else DFT_BLOCK_ROWS
        ring = STREAM_STAGES * stage
        if chunked:
            ring = max(ring, CONV_RING_STREAMED * 2 * step + product)
        act_a = max(acts, A_STAGES * frames * (a_rows + STREAM_ROW_PAD) + 256)
        return 4 * (ring + act_a + max(frames * spec.n_bins, acts) + sums)
    stages = DFT_STAGES * 2 * 2 * step * _dft_chunks(spec)
    staged = max(rows, product)
    if conv_passes > 0:
        chunks = -(-spec.time_range * spec.net.layer_sizes[0][1] // DFT_UNIT_COLS)
        staged = max(staged, frames * (DFT_UNIT_COLS * chunks + 8))
        stages = max(stages, 2 * -(-spec.n_bins // BF16_STEP_ROWS) * chunks * step)
    return 4 * (staged + stages + frames * spec.n_bins + frames + 2 * tile * max_width)


LAYOUTS = ("resident", "span", "streamed")


class CtaChoice(NamedTuple):
    """How the kernel cuts one launch: ``frames`` a CTA transforms, and its
    shared-memory layout, named by ``col_group``: resident (0), span (-n:
    the span resident, C streamed over n chunks a pass over k) or streamed
    (n: A streamed too) (:func:`smem_bytes`)."""

    frames: int
    col_group: int = 0

    @property
    def layout(self) -> str:
        return LAYOUTS[0 if self.col_group == 0 else (1 if self.col_group < 0 else 2)]


def cta_choice(spec: DetectorSpec, n_evals: int, lanes: int, max_width: int,
               n_sm: int = H100_SMS, tier: str | None = None,
               frames_input: bool = False, layouts: tuple = LAYOUTS) -> CtaChoice:
    """Frames and layout of one CTA of the kernel for a launch of ``lanes``
    x ``n_evals`` evaluations on a card of ``n_sm`` SMs, under ``tier`` and
    input form as :func:`smem_bytes` takes them.

    A CTA of ``f`` frames serves ``f - timeRange + 1`` evaluations, so a
    large ``f`` wastes few transforms (128 frames: 1.08 per evaluation at
    timeRange 10, 64 frames: 1.16), while a CTA's time hardly depends on
    ``f`` (its chain of barriers and loads does not). The choice over
    :data:`CTA_FRAMES` takes the fewest waves, ``ceil(CTAs / (n_sm * CTAs
    resident on an SM))`` (by shared memory and :data:`KERNEL_REGISTERS`),
    then the fewest frames in all, then the larger
    ``f``: 64 frames for a live bucket on 256 lanes, 128 for one 60 s
    stream and for long lanes. A ``timeRange`` above every choice takes the
    next multiple of 64.

    The ``layouts`` are tried in order (:func:`col_group_for`): resident
    wherever a choice fits (the sample geometry's every path), else for
    each ``f`` of 128 frames or more the span layout, else the streamed
    one, with a round's chunks of C a pass (:func:`round_chunks`). Raises,
    naming :data:`ENVELOPE`, when none fits.

    The choice depends on the launch alone: ``python -m
    syllable_detector_tpu_torch tune`` reports how it compares with the
    other candidates on a card, and changes nothing."""
    halo = spec.time_range - 1
    choices = _frame_choices(spec)
    best = None
    for frames in choices:
        group = col_group_for(spec, frames, max_width, tier, frames_input, layouts)
        if group is None:
            continue
        smem = smem_bytes(spec, frames, max_width, tier, frames_input, group)
        threads = 128 * min(2, frames // 64 * _dft_chunks(spec))
        layout = CtaChoice(frames, group).layout
        if layout == "resident" and tier is None and tc_first_layer(spec):
            layout = "resident tc"
        regs = KERNEL_REGISTERS[layout] * threads
        resident = max(1, min(SM_SMEM // (smem + 1024), SM_REGISTERS // regs))
        ctas = lanes * -(-n_evals // (frames - halo))
        key = (-(-ctas // (n_sm * resident)), ctas * frames, -frames)
        if best is None or key < best[0]:
            best = (key, CtaChoice(frames, group))
    if best is None:
        need = smem_bytes(spec, choices[0], max_width, tier, frames_input, 1)
        raise ValueError(
            f"the fused kernel needs {need} bytes of shared memory per CTA at fft "
            f"{spec.fourier_length}, {spec.n_bins} bins, timeRange {spec.time_range} and "
            f"layers up to {max_width} wide; the card offers {SMEM_LIMIT}. Its envelope: "
            f"{ENVELOPE}"
        )
    return best[1]


def _frame_choices(spec: DetectorSpec) -> list[int]:
    """The frames a CTA may transform: :data:`CTA_FRAMES` above timeRange -
    1, or the next multiple of 64 above it."""
    halo = spec.time_range - 1
    return [f for f in CTA_FRAMES if f > halo] or [_round_up(halo + 1, 64)]


def round_chunks(spec: DetectorSpec, frames: int) -> int:
    """Chunks of C one round of a CTA's two warpgroups covers outside the
    resident layout, each warpgroup taking a 64-frame group and two chunks
    (two chains of products), its units going chunk by chunk: two where
    the CTA has two 64-frame groups or more, four where it has one (as far
    as the bins fill them)."""
    return min(_dft_chunks(spec), 2 * max(1, 2 // (frames // 64)))


def col_group_for(spec: DetectorSpec, frames: int, max_width: int,
                  tier: str | None = None, frames_input: bool = False,
                  layouts: tuple = LAYOUTS) -> int | None:
    """The layout a CTA of ``frames`` frames takes, as :func:`cta_choice`
    takes it, the ``layouts`` tried in order: 0 (resident) where some
    frames choice fits there; else the span layout (-n) where this
    ``frames`` is 128 or more and fits there; else the streamed one (n).
    Outside the resident layout a pass over k covers n =
    :func:`round_chunks` chunks of C, or fewer where they do not fit: more
    would stream chunks that a round does not use. A 64-frame CTA streams
    A: a span pass serves one 64-frame group a block of C, from a shallower
    ring than the streamed layout's, and on an H100 the span layout is
    mostly slower there than the launch taken without it, and faster at 128
    frames (``scripts/k1_choices.py layouts`` times both). None where this
    ``frames`` does not fit the layout taken."""

    def fits(group: int) -> bool:
        return smem_bytes(spec, frames, max_width, tier, frames_input, group) <= SMEM_LIMIT

    if "resident" in layouts and any(
            smem_bytes(spec, f, max_width, tier, frames_input) <= SMEM_LIMIT
            for f in _frame_choices(spec)):
        return 0 if fits(0) else None
    signs = (-1, 1) if "span" in layouts and frames >= 128 else (1,)
    return next((sign * g for sign in signs for g in range(round_chunks(spec, frames), 0, -1)
                 if fits(sign * g)), None)


def cta_frames(spec: DetectorSpec, n_evals: int, lanes: int, max_width: int,
               n_sm: int = H100_SMS, tier: str | None = None,
               frames_input: bool = False) -> int:
    """The frames of :func:`cta_choice` (same arguments)."""
    return cta_choice(spec, n_evals, lanes, max_width, n_sm, tier, frames_input).frames


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


STAGES = ("staging", "C wait", "band DFT", "A and C copies", "|X|", "first layer", "rest")


def stage_shares(launch, device="cuda") -> dict:
    """Where the kernel's CTAs spend their cycles: runs ``launch()`` (any
    call that launches the kernel of ``csrc/fused_detector.cu`` on
    ``device``, under any tier or input form) with the kernel's
    ``clock64()`` counters on, and returns each
    stage's share of the cycles the CTAs' first threads counted
    (:data:`STAGES`: staging the span, waiting for a block of C, the wgmma
    steps, the streamed layout's copies of the next block of A and C while
    the tensor cores run, |X| and scaling, row sums and first layer, hidden
    layers and output). CTAs that share an SM slow each other, so the shares say where
    a CTA waits, not what a stage costs alone. For measurements only."""
    lib = _library()
    counters = torch.zeros(8, dtype=torch.int64, device=device)
    torch.cuda.synchronize(device)
    lib.sd_fused_detector_set_profile(counters.data_ptr())
    try:
        launch()
        torch.cuda.synchronize(device)
    finally:
        lib.sd_fused_detector_set_profile(None)
    c = counters.cpu().numpy().astype(np.float64)
    total = float(c.sum())
    order = (0, 4, 5, 6, 1, 2, 3)
    return {name: float(c[i]) / total for name, i in zip(STAGES, order)}


def _check_launchable(x: torch.Tensor, folded: FusedOperands, lanes: int) -> None:
    """Raise unless ``x`` lies on a Hopper card with ``folded`` beside it."""
    if x.device.type != "cuda":
        raise ValueError(f"no fused detector kernel for device {x.device}")
    operands = (folded.c, folded.c_tiled, folded.c_bf16, folded.w1g_bf16, folded.w1g_tf32,
                folded.w1, folded.c1, folded.mids_flat, folded.out_a, folded.out_c)
    if any(o is not None and o.device != x.device for o in operands):
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
    frames: int | None = None,
    col_group: int | None = None,
    tc: bool | None = None,
) -> torch.Tensor:
    """One launch over lanes ``[lane0, lane0 + lanes)`` of ``xs`` (on the
    card: ``[C, n]`` samples of the wire's type or, with ``frames_input``,
    ``[C, F, window]`` float32 frames) into the same lanes of ``out``
    ``[C, n_evals, outputs]`` float32 (allocated when None), which it
    returns, under ``tier`` (a :data:`TIERS` key, None for full fp32). The
    lanes' slice of every operand is a pointer offset. ``frames`` per CTA
    and the layout's ``col_group`` default to :func:`cta_choice`'s (``tune``
    times other frames, ``chip_smoke.py`` forces the other layouts that
    fit); ``frames`` alone takes the resident layout. ``tc`` forces the
    fp32 first layer onto the tensor cores or off them (default:
    :func:`tc_first_layer`; ``chip_smoke.py`` times both). Counts the launch
    in :data:`LAYOUT_LAUNCHES`."""
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
    if (tier is not None or frames_input) and wire != "float32":
        raise ValueError("the tiers and the frames input read float32 only")
    lib = _library()
    widths = [w for _, w in spec.net.layer_sizes]
    gap, _ = normalize_overlap(spec.window_overlap)
    geometry = (spec.window_length, spec.hop, gap, spec.n_bins, spec.time_range)
    dft_passes = TIERS[tier][0] if tier else 0
    conv_passes = _conv_passes(spec, tier, tc)
    cs = folded.c_bf16 if dft_passes else folded.c_tiled
    want_c = (lib.sd_fused_detector_c_blocks(spec.window_length, dft_passes), 2, 2,
              lib.sd_fused_detector_c_chunks(spec.n_bins), 8, 2, 8, 8 if dft_passes else 4)
    if cs is None or tuple(cs.shape) != want_c:
        raise ValueError(
            f"the fused kernel takes C tiled as {want_c} "
            f"({'tile_dft_matrix_bf16' if dft_passes else 'tile_dft_matrix'})")
    bank = None
    if conv_passes == CONV_TF32:
        bank = folded.w1g_tf32
        if bank is None:  # a first layer forced onto the tensor cores
            tiled = [tile_conv_bank_tf32(w) for w in (folded.w1 if folded.per_lane
                                                     else folded.w1[None])]
            bank = torch.stack(tiled) if folded.per_lane else tiled[0]
        floats = lib.sd_fused_detector_tf32_bank_floats(spec.n_bins, spec.time_range, widths[0])
        name = "tile_conv_bank_tf32 for the fp32 first layer on the tensor cores"
    elif conv_passes:
        bank = folded.w1g_bf16
        floats = lib.sd_fused_detector_conv_bank_floats(spec.n_bins, spec.time_range, widths[0])
        name = "tile_conv_bank_bf16 under this tier"
    if conv_passes:
        one_net = bank[0] if bank is not None and folded.per_lane else bank
        if one_net is None or one_net.numel() * one_net.element_size() != 4 * floats:
            raise ValueError(f"the fused kernel takes the conv filter bank of {name}")
    if frames is None:
        frames, chosen = cta_choice(spec, n_evals, lanes, max(widths), _sm_count(xs.device),
                                    tier, frames_input)
        col_group = chosen if col_group is None else col_group
    col_group = col_group or 0
    smem = lib.sd_fused_detector_smem_bytes(
        *geometry, frames, max(widths), widths[0], dft_passes, conv_passes, int(frames_input),
        col_group)
    mirror = smem_bytes(spec, frames, max(widths), tier, frames_input, col_group, tc)
    if smem != mirror:
        raise RuntimeError(
            f"the kernel's shared memory ({smem} bytes) is not smem_bytes' ({mirror})")
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
    codes = tuple(TRANSFER_CODES[t] for t in spec.net.transfers)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_transfers = (ctypes.c_int * len(widths))(*codes)
    layers = _layer_table(tuple(widths), codes, xs.device)

    def at(t: torch.Tensor, per_net: bool = True) -> int:
        """``t``'s address at lane ``lane0``: ``xs`` and ``out`` have a lane
        axis, a net operand only when the nets are per lane."""
        if per_net and not folded.per_lane:
            return t.data_ptr()
        return t.data_ptr() + lane0 * t.stride(0) * t.element_size()

    scale = MULAW_INV127 if wire == "mulaw8" else INT16_SCALE
    # the library makes xs's card current; the guard gives the caller's back
    with torch.cuda.device(xs.device):
        err = lib.sd_fused_detector(
            at(xs, False), WIRE_CODES[wire], lanes, xs.stride(0), n, n_evals,
            cs.data_ptr(), at(folded.w1), at(bank) if conv_passes else None,
            at(folded.c1), at(folded.mids_flat), at(folded.out_a), at(folded.out_c),
            at(out, False), int(folded.per_lane),
            *geometry, SCALING_CODES[spec.scaling], int(folded.has_l2), frames,
            dft_passes, conv_passes, int(frames_input), col_group,
            len(widths), c_widths, c_transfers, layers.data_ptr(),
            float(scale), float(MULAW_LN1MU), float(MULAW_INV_MU),
            xs.device.index, torch.cuda.current_stream(xs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "fused detector kernel launch failed: "
            f"{lib.sd_error_string(err).decode()} (cudaError {err})"
        )
    LAYOUT_LAUNCHES[CtaChoice(frames, col_group).layout] += 1
    return out


@functools.lru_cache(maxsize=64)
def _layer_table(widths: tuple, transfers: tuple, device: torch.device) -> torch.Tensor:
    """The kernel's table of layer widths, then Transfer codes: ``[2,
    layers]`` int32 on ``device``, uploaded once per net shape."""
    return torch.tensor([widths, transfers], dtype=torch.int32, device=device)
