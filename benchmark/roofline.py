"""Operations, bytes and the least time of the port's kernels, from shapes.

A frozen copy of ``chip_smoke.py:366-369`` (the peaks) and of
``chip_smoke.bound`` / ``fused_bound`` / ``framed_bound``
(``chip_smoke.py:437-483``), written against this folder's geometry
dictionaries instead of the port's ``DetectorSpec``, with the precision tiers
left out (no cell runs a tier). The counts are of the work the inputs need:
the real, unpadded samples of a call, not what a kernel pads them to.
"""

from __future__ import annotations

import math

# published peaks of one H100 SXM (dense, no sparsity, at its 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the float32
    operations over the peak rate outside the tensor cores and the bytes
    over the memory rate."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


def hop(geom: dict) -> int:
    overlap = geom["window_overlap"]
    gap = -overlap if overlap < 0 else 0
    return gap + geom["window_length"] - max(overlap, 0)


def num_frames(n: int, geom: dict) -> int:
    """Spectral frames of ``n`` samples (``ops/stft.num_frames``)."""
    overlap = geom["window_overlap"]
    need = (-overlap if overlap < 0 else 0) + geom["window_length"]
    return 0 if n < need else 1 + (n - need) // hop(geom)


def bins(geom: dict) -> tuple[int, int]:
    """The band's DFT bins [lo, hi) (``ops/stft.frequency_index_range``)."""
    fft, rate = geom["fourier_length"], geom["sampling_rate"]
    f0, f1 = geom["freq_range"]
    lo = int(math.ceil(fft / rate * f0))
    hi = min(int(math.floor(fft / rate * f1)) + 1, fft // 2)
    return lo, hi


def layer_sizes(geom: dict) -> list[tuple[int, int]]:
    lo, hi = bins(geom)
    widths = [(hi - lo) * geom["time_range"], *geom["hidden"], 1]
    return list(zip(widths[:-1], widths[1:]))


def detect_flops(geom: dict, frames: int, evals: int) -> float:
    """Float32 operations of the fused detector on ``frames`` frames giving
    ``evals`` evaluations: the band DFT (re and im, 2 * window * 2 * bins a
    frame), |X| and the sliding squared sum (5 * bins a frame), and every
    layer's product an evaluation."""
    lo, hi = bins(geom)
    b = hi - lo
    sizes = layer_sizes(geom)
    return (frames * (4 * geom["window_length"] * b + 5 * b)
            + evals * sum(2 * i * o for i, o in sizes))


def fused_bound(geom: dict, lane_samples: list[int], itemsize: int, nets: int) -> float:
    """Least seconds of fused detector work on lanes of the given real
    sample counts, on a wire of ``itemsize`` bytes a sample with ``nets``
    distinct nets: the samples and the outputs once, each net's DFT matrix
    and weights once. Transfer functions are not counted."""
    lo, hi = bins(geom)
    sizes = layer_sizes(geom)
    flops, nbytes = 0.0, 0.0
    for n in lane_samples:
        frames = num_frames(n, geom)
        evals = max(0, frames - geom["time_range"] + 1)
        flops += detect_flops(geom, frames, evals)
        nbytes += n * itemsize + evals * 4
    operands = 2 * geom["window_length"] * (hi - lo) + sum(i * o + o for i, o in sizes)
    return bound_s(flops, nbytes + nets * operands * 4)


def framed_bound(x_numel: int, g_numel: int, g_nnz: int, up: int, n_frames: int) -> float:
    """Least seconds of one framed GEMM (the resampler's K2): the samples,
    G and the output once; two operations for each non-zero of G in each
    frame."""
    return bound_s(2.0 * n_frames * g_nnz, 4 * (x_numel + g_numel + n_frames * up))


def train_step_flops(geom: dict, rows: int, nets: int) -> float:
    """Float32 operations of one training step on ``rows`` feature rows of
    ``nets`` stacked nets: each layer's product forward (2 * in * out a
    row) and, backward, the weights' gradient (the same) and, for every
    layer after the first, the input's gradient (the same again)."""
    sizes = layer_sizes(geom)
    fwd = sum(2 * i * o for i, o in sizes)
    bwd = sum(2 * i * o for i, o in sizes) + sum(2 * i * o for i, o in sizes[1:])
    return float(rows * nets * (fwd + bwd))
