"""Sample-rate conversion: streaming linear (host-side numpy) and polyphase
(one framed GEMM on the card).

Counterpart of ``syllable_detector_tpu.ops.resample``:
:func:`linear_resample_chunk` is the bit-matching port of the reference's
streaming linear interpolator ``ResamplerLinear`` (float32 index ramp,
table-lookup interpolation, and the fractional ``offset`` / ``last``-sample
carry across chunk boundaries, quirks included);
:func:`linear_resample_chunk_exact` is the drift-free variant the live
``Processor`` uses for a lane whose device rate differs from its net's.
:func:`polyphase_resample` is the quality path the CLI and the corpus scan
use for a file whose rate differs from the net's: rational upfirdn with a
Kaiser windowed-sinc design, planned in float64 numpy
(:func:`polyphase_plan`) and run as one framed GEMM
(``kernels.framed_gemm``: the CUDA kernel on a card, its plain version on
the CPU).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from syllable_detector_tpu_torch.kernels.framed_gemm import framed_gemm

__all__ = [
    "LinearResamplerState",
    "linear_resample_init",
    "linear_resample_chunk",
    "linear_resample_chunk_exact",
    "linear_resample",
    "polyphase_filter_bank",
    "polyphase_framing",
    "polyphase_plan",
    "polyphase_resample",
]


@dataclass
class LinearResamplerState:
    """Carry across chunks (Resampler.swift:25-26)."""

    step: np.float32  # in_rate / out_rate, float32 like the reference
    last: np.float32 = np.float32(0.0)
    offset: np.float32 = np.float32(0.0)
    step64: float = 0.0  # full-precision step, used by the exact variant


def linear_resample_init(in_rate: float, out_rate: float) -> LinearResamplerState:
    # step computed in double then narrowed, like Float(samplingRateIn /
    # samplingRateOut) (Resampler.swift:32)
    ratio = float(in_rate) / float(out_rate)
    return LinearResamplerState(step=np.float32(ratio), step64=ratio)


def linear_resample_chunk(
    data: np.ndarray, state: LinearResamplerState
) -> tuple[np.ndarray, LinearResamplerState]:
    """Resample one chunk, updating the carried state.

    Mirrors ResamplerLinear.resampleVector (Resampler.swift:35-70) bit for
    bit, float32 arithmetic included — *including* two reference quirks kept
    for fidelity:

      * one-sample-per-chunk position drift: the carried ``offset`` is
        rebased to sample ``n-1`` (Resampler.swift:65) while the next chunk's
        first sample is global position ``n``, so every chunk boundary skips
        one input sample position (harmless for its live use with
        near-matching device rates);
      * when the interpolate-across branch fires, ``indices[0]`` is mutated
        to 0 *before* the carry reads ``indices[numOut-1]``
        (Resampler.swift:54-65), shifting the carry when numOut == 1.

    Use :func:`linear_resample_chunk_exact` for drift-free streaming.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), state

    step = np.float32(state.step)
    offset = np.float32(state.offset)

    interpolate_across = bool(offset < 0)

    num_out = int((np.float32(n) - offset) / step)
    if num_out <= 0:
        # Not enough input to emit a sample; the reference never hits this
        # (reads indices[-1], UB) — carry the offset gracefully instead.
        new_state = LinearResamplerState(
            step=step,
            last=np.float32(data[n - 1]),
            offset=np.float32(offset - np.float32(n - 1)),
        )
        return np.zeros(0, np.float32), new_state

    # vDSP_vramp: indices[k] = offset + k*step, float32 (Resampler.swift:52)
    indices = offset + np.arange(num_out, dtype=np.float32) * step
    if interpolate_across:
        indices = indices.copy()
        indices[0] = np.float32(0.0)

    # vDSP_vlint: out[k] = d[j] + frac*(d[j+1]-d[j]), j = floor(idx)
    # (Resampler.swift:59). Clamp the j+1 lookup at the final sample for
    # fractional indices beyond n-1 (only reachable when upsampling).
    out = _vlint(data, indices)

    if interpolate_across:
        # ret[0] = last*(0-offset) + data[0]*(1+offset) (Resampler.swift:62)
        out[0] = np.float32(state.last) * (np.float32(0.0) - offset) + data[0] * (
            np.float32(1.0) + offset
        )

    new_offset = np.float32(indices[num_out - 1] + step - np.float32(n - 1))
    new_state = LinearResamplerState(
        step=step, last=np.float32(data[n - 1]), offset=new_offset
    )
    return out, new_state


def _vlint(data: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """vDSP_vlint: table-lookup linear interpolation, clamped at the ends."""
    n = data.shape[0]
    j = np.clip(np.floor(indices).astype(np.int64), 0, n - 1)
    j1 = np.minimum(j + 1, n - 1)
    frac = (indices - j.astype(indices.dtype)).astype(np.float32)
    d0 = data[j]
    return (d0 + frac * (data[j1] - d0)).astype(np.float32)


def linear_resample_chunk_exact(
    data: np.ndarray, state: LinearResamplerState
) -> tuple[np.ndarray, LinearResamplerState]:
    """Drift-free streaming linear interpolation (the runtime default).

    Same interpolation math as the reference, but the fractional position is
    carried in float64 relative to the true next-sample origin, so streaming
    any chunking equals resampling the whole stream at once (up to float32
    interpolation rounding).
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), state

    step = state.step64 if state.step64 else float(state.step)
    offset = float(state.offset)

    interpolate_across = offset < 0

    # emit positions <= n-1; anything in (n-1, n) defers to the next chunk's
    # interpolate-across blend
    num_out = int((n - 1 - offset) / step) + 1 if offset <= n - 1 else 0
    if num_out <= 0:
        new_state = LinearResamplerState(
            step=state.step,
            last=np.float32(data[n - 1]),
            offset=offset - n,
            step64=step,
        )
        return np.zeros(0, np.float32), new_state

    positions = offset + np.arange(num_out, dtype=np.float64) * step
    lookup = positions.copy()
    if interpolate_across:
        lookup[0] = 0.0
    out = _vlint(data, lookup)
    if interpolate_across:
        out[0] = np.float32(state.last) * np.float32(-offset) + data[0] * np.float32(
            1.0 + offset
        )

    new_offset = positions[num_out - 1] + step - n
    new_state = LinearResamplerState(
        step=state.step,
        last=np.float32(data[n - 1]),
        offset=new_offset,
        step64=step,
    )
    return out, new_state


def linear_resample(data: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray:
    """Whole-array convenience wrapper (Resampler.swift:72-76)."""
    out, _ = linear_resample_chunk(data, linear_resample_init(in_rate, out_rate))
    return out


# ---------------------------------------------------------------------------
# polyphase FIR (quality path, one framed GEMM)
# ---------------------------------------------------------------------------


def _kaiser_sinc_filter(up: int, down: int, half_width: int, beta: float) -> np.ndarray:
    """Lowpass FIR on the up-sampled grid, cutoff Nyquist/max(up, down)."""
    max_rate = max(up, down)
    numtaps = 2 * half_width * max_rate + 1
    n = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    cutoff = 1.0 / max_rate  # fraction of Nyquist on the upsampled grid
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(numtaps, beta)
    # normalize DC gain to `up` so amplitudes survive zero-stuffing
    h = h / np.sum(h) * up
    return h


def polyphase_filter_bank(
    up: int, down: int, half_width: int = 10, beta: float = 5.0
) -> tuple[np.ndarray, int]:
    """Per-phase filter bank Hb[up, taps] and the filter's group delay
    (in upsampled samples)."""
    h = _kaiser_sinc_filter(up, down, half_width, beta)
    half = (len(h) - 1) // 2
    taps = int(math.ceil(len(h) / up))
    hb = np.zeros((up, taps), dtype=np.float64)
    for p in range(up):
        sub = h[p::up]
        hb[p, : len(sub)] = sub
    return hb.astype(np.float32), half


def polyphase_plan(up: int, down: int, half_width: int = 10, beta: float = 5.0):
    """Framing plan that turns rational resampling into one framed GEMM.

    Output k (= a*up + r) reads the input window ending at m = base//up with
    phase base % up, where base = k*down + half on the upsampled grid. Block
    a's windows for every phase live inside one contiguous input span of
    width W = (max-min window end) + taps, so the whole resampler is
    hop-strided framing followed by a single [blocks, W] @ [W, up]
    contraction against a filter matrix with each phase's taps scattered at
    its own offsets.

    Returns (g [W, up] float32, lead, w_len, overlap): frame the input
    (left-padded/trimmed by ``lead``) with window ``w_len`` and
    ``overlap`` (negative = gap), then ``frames @ g`` and flatten.
    """
    hb, half = polyphase_filter_bank(up, down, half_width, beta)
    taps = hb.shape[1]
    r = np.arange(up, dtype=np.int64)
    base_r = r * down + half
    phase = base_r % up
    m_off = base_r // up

    # frame a covers input positions [a*down + start0, a*down + start0 + W)
    # (in unpadded x coordinates); tap t of phase r reads column
    # m_off[r] - t - start0
    start0 = int(m_off.min()) - (taps - 1)
    w_len = int(m_off.max()) - start0 + 1

    g = np.zeros((w_len, up), np.float32)
    for rr in range(up):
        for t in range(taps):
            g[int(m_off[rr]) - t - start0, rr] = hb[phase[rr], t]

    # align frame_signal's gap offset (negative overlap) with start0
    overlap = w_len - down
    gshift = max(0, down - w_len)
    lead = gshift - start0
    return g, lead, w_len, overlap


def _polyphase_lead(x: torch.Tensor, lead: int) -> torch.Tensor:
    if lead > 0:
        return torch.cat([x.new_zeros(lead), x])
    if lead < 0:
        return x[-lead:]
    return x


@functools.lru_cache(maxsize=32)
def _device_plan(up: int, down: int, half_width: int, beta: float, device: torch.device):
    """(g on ``device``, lead, w_len, overlap), planned once per rate pair."""
    g, lead, w_len, overlap = polyphase_plan(up, down, half_width, beta)
    return torch.from_numpy(g).to(device), lead, w_len, overlap


def polyphase_framing(
    x,
    in_rate: float,
    out_rate: float,
    half_width: int = 10,
    beta: float = 5.0,
    max_denominator: int = 1000,
    device="cuda",
):
    """The framed GEMM that resamples one channel ([n] samples, numpy or a
    tensor): ``(xin, g, w_len, overlap, blocks, n_out)`` on ``device``, or
    ``(x, None, 0, 0, 0, n)`` when the rate ratio rounds to 1. The result
    is ``framed_gemm(xin, g, w_len, overlap, blocks).reshape(-1)[:n_out]``.
    """
    frac = Fraction(float(out_rate) / float(in_rate)).limit_denominator(
        max_denominator
    )
    up, down = frac.numerator, frac.denominator
    device = torch.device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    n = x.shape[0]
    if up == down:
        return x, None, 0, 0, 0, n
    n_out = -(-n * up // down)
    g, lead, w_len, overlap = _device_plan(up, down, half_width, float(beta), device)
    blocks = -(-n_out // up)
    xin = _polyphase_lead(x, lead).contiguous()
    return xin, g, w_len, overlap, blocks, n_out


def polyphase_resample(
    x,
    in_rate: float,
    out_rate: float,
    half_width: int = 10,
    beta: float = 5.0,
    max_denominator: int = 1000,
    device="cuda",
) -> torch.Tensor:
    """High-quality rational resampling of one channel ([n] samples, numpy
    or a tensor) -> float32 [ceil(n * up / down)] on ``device``.

    The rate ratio is approximated as a fraction (e.g. 96k -> 44.1k is
    147/320); the result matches scipy.signal.resample_poly's upfirdn
    semantics with a Kaiser(beta) windowed-sinc design. On a card the
    product runs in the framed GEMM kernel; on the CPU in its plain version
    (fp32).
    """
    xin, g, w_len, overlap, blocks, n_out = polyphase_framing(
        x, in_rate, out_rate, half_width, beta, max_denominator, device
    )
    if g is None:
        return xin
    y = framed_gemm(xin, g, w_len, overlap, blocks)
    return y.reshape(-1)[:n_out]
