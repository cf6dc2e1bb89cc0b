"""Streaming linear sample-rate conversion (host-side numpy).

Counterpart of the linear part of ``syllable_detector_tpu.ops.resample``:
:func:`linear_resample_chunk` is the bit-matching port of the reference's
streaming linear interpolator ``ResamplerLinear`` (float32 index ramp,
table-lookup interpolation, and the fractional ``offset`` / ``last``-sample
carry across chunk boundaries, quirks included);
:func:`linear_resample_chunk_exact` is the drift-free variant the live
``Processor`` uses for a lane whose device rate differs from its net's.
The JAX module imports jax for its polyphase part, so the port carries its
own copy of these numpy functions. The polyphase path (a Pallas kernel in
the JAX package) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "LinearResamplerState",
    "linear_resample_init",
    "linear_resample_chunk",
    "linear_resample_chunk_exact",
    "linear_resample",
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
