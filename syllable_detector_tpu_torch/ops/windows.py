"""Window functions, numerically matching Apple vDSP's definitions.

vDSP's hamming / hanning / blackman windows are *periodic* (denominator N,
not N-1):

    hamming:  w[n] = 0.54 - 0.46 cos(2*pi*n / N)
    hanning:  w[n] = 0.5  - 0.5  cos(2*pi*n / N)
    blackman: w[n] = 0.42 - 0.5 cos(2*pi*n / N) + 0.08 cos(4*pi*n / N)

Counterpart of ``syllable_detector_tpu.ops.windows``: computed in float64
numpy and cast once, so both packages hold the same float32 constants.
"""

from __future__ import annotations

import numpy as np

WINDOW_TYPES = ("none", "hamming", "hanning", "blackman")


def make_window(window_type: str, length: int, dtype=np.float32) -> np.ndarray:
    """Build a window of ``length`` samples as a host-side numpy constant."""
    if length <= 0:
        raise ValueError("window length must be positive")
    n = np.arange(length, dtype=np.float64)
    if window_type == "none":
        w = np.ones(length, dtype=np.float64)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / length)
    elif window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)
    elif window_type == "blackman":
        w = (
            0.42
            - 0.5 * np.cos(2.0 * np.pi * n / length)
            + 0.08 * np.cos(4.0 * np.pi * n / length)
        )
    else:
        raise ValueError(f"unknown window type {window_type!r}")
    return w.astype(dtype)
