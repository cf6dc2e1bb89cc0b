"""Plain detection and resampling: what the detector computes, in float64.

Written from the reference's description (SURVEY.md rows 2-4, 15, 20), not
from the port: hop-strided frames of ``window`` samples, a periodic Hamming
window (vDSP's, denominator N), the magnitude of DFT bins [lo, hi) of the
zero-padded frame, ``timeRange`` consecutive frames concatenated oldest
first (frequency fastest), l2normalize then mapminmax on the input, the
layers, and the output mapminmax's reverse. Output ``k`` belongs to sample
``window + hop * (timeRange - 1) + hop * k``, the count of samples it has
seen (TrackDetector.swift:38-42).

Resampling is rational upfirdn with a Kaiser(5) windowed-sinc lowpass of
half-width 10 input periods, its DC gain ``up``, delayed by half its length,
``ceil(n * up / down)`` outputs: scipy's ``resample_poly`` semantics, which
the port's CLI states it follows.

``precision="float64"`` is the reference. ``precision="tf32"`` is its
control: every matrix product's operands rounded to TF32 (10 bits of
mantissa, as the tensor cores read float32 with TF32 on) and the rest in
float32, the precision one step below the configuration's float32 with
TF32 off.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from benchmark import roofline

TRANSFERS = {
    "TanSig": torch.tanh,
    "LogSig": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "PureLin": lambda x: x,
    "SatLin": lambda x: torch.clamp(x, 0.0, 1.0),
}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


def band_matrix(geom: dict, device) -> torch.Tensor:
    """[window, 2 * bins] float64: the windowed DFT's cosine and negative
    sine columns of the band's bins."""
    w_len, fft = geom["window_length"], geom["fourier_length"]
    lo, hi = roofline.bins(geom)
    n = np.arange(w_len, dtype=np.float64)
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / w_len)
    ang = 2.0 * np.pi * n[:, None] * np.arange(lo, hi, dtype=np.float64)[None, :] / fft
    c = np.concatenate([window[:, None] * np.cos(ang), -window[:, None] * np.sin(ang)], 1)
    return torch.from_numpy(c).to(device)


def first_output_sample(geom: dict) -> int:
    overlap = geom["window_overlap"]
    gap = -overlap if overlap < 0 else 0
    return gap + geom["window_length"] + roofline.hop(geom) * (geom["time_range"] - 1)


def features(geom: dict, x: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """[n] samples -> [E, timeRange * bins] stacked band magnitudes."""
    dt = dtype_of(precision)
    x = x.to(dt)
    f = roofline.num_frames(len(x), geom)
    t_range = geom["time_range"]
    e = f - t_range + 1
    lo, hi = roofline.bins(geom)
    b = hi - lo
    if e <= 0:
        return x.new_zeros((0, t_range * b))
    overlap = geom["window_overlap"]
    gap = -overlap if overlap < 0 else 0
    w_len, step = geom["window_length"], roofline.hop(geom)
    frames = x[gap : gap + (f - 1) * step + w_len].unfold(0, w_len, step)
    c = band_matrix(geom, x.device).to(dt)
    out = []
    # blocks of frames keep the product small on long streams
    for s in range(0, f, 1 << 16):
        big = matmul(frames[s : s + (1 << 16)], c, precision)
        out.append(torch.sqrt(big[:, :b] * big[:, :b] + big[:, b:] * big[:, b:]))
    mag = torch.cat(out)
    if geom["scaling"] != "linear":
        raise ValueError("the reference implements linear scaling only")
    return mag.unfold(0, t_range, 1).transpose(1, 2).reshape(e, t_range * b)


def apply_net(net: dict, feats: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """Features [E, D] -> the net's first output [E]: l2normalize, the input
    mapminmax (y offset -1), the layers, the output mapminmax's reverse
    (gain 2, y offset -1, x offset 0)."""
    dt = dtype_of(precision)
    dev = feats.device

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    x = feats.to(dt)
    x = x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    x = (x - t(net["x_offsets"])) * t(net["gains"]) - 1.0
    for w, b, transfer in net["layers"]:
        x = TRANSFERS[transfer](matmul(x, t(w).T, precision) + t(b))
    return ((x + 1.0) / 2.0)[:, 0]


def outputs(geom: dict, net: dict, x: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """The net's first output at every evaluation of the stream ``x``."""
    return apply_net(net, features(geom, x, precision), precision)


def plan(in_rate: float, out_rate: float, half_width: int = 10, beta: float = 5.0):
    """(up, down, filter h [L] float64) of the rational resampler; h is
    None where the ratio rounds to 1."""
    frac = Fraction(float(out_rate) / float(in_rate)).limit_denominator(1000)
    up, down = frac.numerator, frac.denominator
    if up == down:
        return up, down, None
    max_rate = max(up, down)
    length = 2 * half_width * max_rate + 1
    n = np.arange(length, dtype=np.float64) - (length - 1) / 2.0
    cutoff = 1.0 / max_rate
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(length, beta)
    return up, down, h / np.sum(h) * up


def resample(x: torch.Tensor, in_rate: float, out_rate: float,
             precision: str = "float64") -> torch.Tensor:
    """[n] -> [ceil(n * up / down)]: y[k] = sum_m x[m] h[k*down + half - m*up]."""
    up, down, h = plan(in_rate, out_rate)
    dt = dtype_of(precision)
    x = x.to(dt)
    if h is None:
        return x
    half = (len(h) - 1) // 2
    taps = -(-len(h) // up)
    bank = np.zeros((up, taps))
    for p in range(up):
        bank[p, : len(h[p::up])] = h[p::up]
    bank = torch.from_numpy(bank).to(x.device).to(dt)
    if precision == "tf32":
        bank, x = tf32(bank), tf32(x)
    n = len(x)
    n_out = -(-n * up // down)
    k = torch.arange(n_out, dtype=torch.int64, device=x.device)
    base = k * down + half
    m, phase = base // up, base % up
    xp = torch.cat([x.new_zeros(taps), x, x.new_zeros(1)])
    y = torch.zeros(n_out, dtype=dt, device=x.device)
    for t in range(taps):
        idx = torch.clamp(m - t + taps, 0, n + taps)
        y += bank[phase, t] * xp[idx]
    return y


def framed_shape(n: int, up: int, down: int, h: np.ndarray) -> tuple[int, int, int, int, int]:
    """(samples read, G's entries, G's non-zeros, up, frames) of the framed
    GEMM that resamples ``n`` samples: the arithmetic of
    ``syllable_detector_tpu_torch/ops/resample.py:241-280`` (``polyphase_plan``)
    and ``:298-309``, for the roofline count alone."""
    half = (len(h) - 1) // 2
    taps = -(-len(h) // up)
    m_off = (np.arange(up) * down + half) // up
    start0 = int(m_off.min()) - (taps - 1)
    w_len = int(m_off.max()) - start0 + 1
    lead = max(0, down - w_len) - start0
    frames = -(-(-(-n * up // down)) // up)
    return n + lead, w_len * up, int(np.count_nonzero(h)), up, frames
