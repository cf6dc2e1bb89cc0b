"""Fused STFT + feature + MLP detection: the CUDA kernel and its plain versions.

Replaces the JAX package's Pallas kernel (``kernels/fused_detector.py``,
``_fused_call`` / ``_make_kernel``) on its full-fp32 raw-sample paths: one
stream (``fused_offline_outputs``), a ``[C, n]`` batch with a shared net or
one net per channel (``fused_flat_batch_offline_outputs``,
``fused_batch_offline_outputs``), and the live drain program that reads
that batch from an int16 or mu-law wire (``fused_batch_program``). All of
them launch the one kernel of ``csrc/fused_detector.cu``. The algebra:

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
:func:`fused_batch_outputs_reference`) for a CPU tensor. Launches are
counted per entry: :data:`LAUNCHES` (one stream), :data:`BATCH_LAUNCHES`
(float32 batches, the float32 wire included) and :data:`PROGRAM_LAUNCHES`
(the dequantising wires).
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
# dequantising wire.
LAUNCHES = 0
BATCH_LAUNCHES = 0
PROGRAM_LAUNCHES = {"int16": 0, "mulaw8": 0}

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


def fused_batch_outputs_reference(
    spec: DetectorSpec,
    folded: FusedOperands,
    xs: torch.Tensor,
    wire: str = "float32",
    n_evals: int | None = None,
) -> torch.Tensor:
    """The batched kernel's plain PyTorch version: ``[L, n]`` wire samples
    -> dequantise -> ``[L, E, outputs]``, with one shared net or one net per
    lane (``folded.per_lane``), on any device. ``n_evals`` defaults to every
    evaluation the ``n`` samples hold."""
    x = dequant(xs, wire)
    lanes, n = x.shape
    t_range = spec.time_range
    if n_evals is None:
        n_evals = _n_evals(spec, n)
    if n_evals <= 0:
        return x.new_zeros((lanes, 0, spec.net.outputs))
    f = n_evals + t_range - 1
    gap, _ = normalize_overlap(spec.window_overlap)
    total = gap + (f - 1) * spec.hop + spec.window_length
    if n < total:
        x = torch.cat([x, x.new_zeros((lanes, total - n))], dim=1)
    frames = x[:, gap:total].unfold(1, spec.window_length, spec.hop)  # [L, F, W]
    big = frames @ folded.c
    b = spec.n_bins
    mag = torch.sqrt(big[..., :b] * big[..., :b] + big[..., b:] * big[..., b:])
    if spec.scaling == "log":
        mag = torch.log(mag)
    elif spec.scaling == "db":
        mag = DB_PER_NEPER * torch.log(mag)

    def per_lane(v):  # a per-lane [L, d] vector broadcast over evaluations
        return v[:, None, :] if folded.per_lane else v

    w1 = folded.w1 if folded.per_lane else folded.w1[None]
    acc = sum(mag[:, t : t + n_evals] @ w1[:, t] for t in range(t_range))
    if folded.has_l2:
        rowsq = torch.sum(mag * mag, dim=2)
        norm = sum(rowsq[:, t : t + n_evals] for t in range(t_range))
        acc = acc / torch.sqrt(norm)[..., None]
    transfers = spec.net.transfers
    h = apply_transfer(acc + per_lane(folded.c1), transfers[0])
    for (w, bb), name in zip(folded.mids, transfers[1:]):
        h = apply_transfer(h @ w + per_lane(bb), name)
    return h * per_lane(folded.out_a) + per_lane(folded.out_c)


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
    global LAUNCHES
    if folded is None:
        folded = fold_constants(spec, params, x.device)
    if x.device.type == "cpu":
        return fused_offline_outputs_reference(spec, folded, x)
    _check_launchable(x, folded, 1)
    if x.dim() != 1:
        raise ValueError(f"expected samples of shape [n], got {tuple(x.shape)}")
    n_evals = _n_evals(spec, x.shape[0])
    if n_evals == 0:
        return x.new_zeros((0, spec.net.outputs))
    out = _launch(spec, folded, x[None], n_evals, "float32")[0]
    LAUNCHES += 1
    return out


def _distinct(params) -> bool:
    return isinstance(params, (list, tuple))


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
    c, n = xs.shape
    if _distinct(params) and len(params) != c:
        raise ValueError(f"{len(params)} per-channel networks for {c} channels")
    max_evals = _n_evals(spec, n)
    if n_evals is None:
        n_evals = max_evals
    elif n_evals > max_evals:
        raise ValueError(f"n_evals={n_evals} needs more than {n} samples")
    if not fusable(spec):
        from syllable_detector_tpu_torch.models.detector import offline_outputs_batch

        return offline_outputs_batch(spec, params, xs)[:, :n_evals]
    if folded is None:
        folded = (
            fold_constants_stacked(spec, params, xs.device)
            if _distinct(params)
            else fold_constants(spec, params, xs.device)
        )
    if n_evals <= 0:
        return xs.new_zeros((c, 0, spec.net.outputs), dtype=torch.float32)
    if xs.device.type == "cpu":
        return fused_batch_outputs_reference(spec, folded, xs, n_evals=n_evals)
    _check_launchable(xs, folded, c)
    out = _launch(spec, folded, xs, n_evals, "float32")
    BATCH_LAUNCHES += 1
    return out


def fused_batch_offline_outputs(
    spec: DetectorSpec,
    params,
    xs: torch.Tensor,
    tile: int | None = None,
    fast: bool = False,
    split: bool | None = None,
    packed: bool | None = None,
    n_evals: int | None = None,
    layout: str = "flat",
) -> torch.Tensor:
    """``[C, n]`` streams -> ``[C, E, outputs]``, shared or distinct nets:
    the full-fidelity fp32 tier, through
    :func:`fused_flat_batch_offline_outputs`. The JAX package's
    channel-grid layout and its fast/split/packed precision tiers are not
    ported yet (ROADMAP B4) and raise; ``tile`` is the kernel's own choice
    and is ignored."""
    if fast or split is not None or packed is not None or layout != "flat":
        raise NotImplementedError(
            "the channel-grid layout and the fast/split/packed precision "
            "tiers are not ported yet (ROADMAP B4)"
        )
    return fused_flat_batch_offline_outputs(spec, params, xs, n_evals=n_evals)


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


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound kernel library (built at the first launch)."""
    from syllable_detector_tpu_torch.kernels import _build

    return _bind(_build.load("fused_detector"))


def _tile(n_evals: int) -> int:
    """Evaluations per CTA: TILE, cut down for small drains as the JAX
    program cuts its flat tile (``min(tile, max(8, round_up(E, 8)))``), so
    that a bucket of 8 does not leave three quarters of each CTA idle."""
    return min(TILE, max(8, -(-n_evals // 8) * 8))


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
    wire: str,
) -> torch.Tensor:
    """One launch over ``xs`` ([lanes, n] of the wire's type, on the card)
    -> [lanes, n_evals, outputs] float32."""
    lanes, n = xs.shape
    if xs.dtype != WIRE_DTYPES[wire] or not xs.is_contiguous():
        raise ValueError(
            f"the fused kernel takes a contiguous [lanes, n] {wire} tensor, got "
            f"{xs.dtype} of shape {tuple(xs.shape)}"
        )
    lib = _library()
    widths = [w for _, w in spec.net.layer_sizes]
    if len(widths) > lib.sd_max_layers():
        raise ValueError(
            f"the fused kernel takes at most {lib.sd_max_layers()} layers"
        )
    gap, _ = normalize_overlap(spec.window_overlap)
    geometry = (spec.window_length, spec.hop, gap, spec.n_bins, spec.time_range)
    tile = _tile(n_evals)
    smem = lib.sd_fused_detector_smem_bytes(*geometry, tile, max(widths))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the fused kernel needs {smem} bytes of shared memory per CTA "
            f"at this geometry; the card offers {SMEM_LIMIT}"
        )
    out = torch.empty(
        (lanes, n_evals, spec.net.outputs), dtype=torch.float32, device=xs.device
    )
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_transfers = (ctypes.c_int * len(widths))(
        *(TRANSFER_CODES[t] for t in spec.net.transfers)
    )
    scale = MULAW_INV127 if wire == "mulaw8" else INT16_SCALE
    err = lib.sd_fused_detector(
        xs.data_ptr(), WIRE_CODES[wire], lanes, n, n, n_evals,
        folded.c.data_ptr(), folded.w1.data_ptr(), folded.c1.data_ptr(),
        folded.mids_flat.data_ptr(), folded.out_a.data_ptr(),
        folded.out_c.data_ptr(), out.data_ptr(), int(folded.per_lane),
        *geometry, SCALING_CODES[spec.scaling], int(folded.has_l2), tile,
        len(widths), c_widths, c_transfers,
        float(scale), float(MULAW_LN1MU), float(MULAW_INV_MU),
        xs.device.index if xs.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "fused detector kernel launch failed: "
            f"{lib.sd_error_string(err).decode()} (cudaError {err})"
        )
    return out
