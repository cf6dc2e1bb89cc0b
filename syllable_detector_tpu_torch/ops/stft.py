"""Framed short-time Fourier transform on torch tensors.

Counterpart of ``syllable_detector_tpu.ops.stft``. The detector needs only a
narrow frequency band, so the band DFT is one matmul of the hop-strided frame
matrix against a windowed band-limited DFT matrix: window multiply, zero
padding, FFT and band slice fold into one contraction.

Numerics replicated from the reference:

  * the detector uses the plain magnitude |X_k| of the standard DFT
    (``kind='magnitude'``); ``kind='power'`` is |X|^2;
  * outputs cover bins [0, fft_length/2): the packed Nyquist bin is zeroed;
  * a negative overlap is a gap: each window skips ``gap`` samples first,
    and the gap applies to the very first window too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from syllable_detector_tpu_torch.ops.windows import make_window

__all__ = [
    "normalize_overlap",
    "hop_length",
    "num_frames",
    "frame_start_indices",
    "slab_parts",
    "frame_signal",
    "band_dft_matrices",
    "spectral_frames",
    "stack_features",
    "frequency_index_range",
    "frequencies_for_sample_rate",
]


def normalize_overlap(window_overlap: int) -> tuple[int, int]:
    """Split a raw windowOverlap into (gap, overlap): negative overlap is a
    gap."""
    if window_overlap < 0:
        return -window_overlap, 0
    return 0, window_overlap


def hop_length(window_length: int, window_overlap: int) -> int:
    gap, overlap = normalize_overlap(window_overlap)
    return gap + window_length - overlap


def num_frames(n_samples: int, window_length: int, window_overlap: int) -> int:
    """How many spectral frames a buffer of ``n_samples`` yields: each
    extraction needs ``gap + window`` samples and consumes one hop."""
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window_length, window_overlap)
    need = gap + window_length
    if n_samples < need:
        return 0
    return 1 + (n_samples - need) // hop


def frame_start_indices(
    n_frames: int, window_length: int, window_overlap: int
) -> np.ndarray:
    """Sample index of the first sample inside each window (after the gap)."""
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window_length, window_overlap)
    return gap + hop * np.arange(n_frames, dtype=np.int64)


def slab_parts(
    window_length: int, window_overlap: int
) -> tuple[int, int, list[tuple[int, int, int]]]:
    """Slab decomposition of hop-strided framing: frame k's column block j
    is row ``k + j`` of the ``[rows, hop]`` reshape of the raw samples.

    Returns (gap, hop, parts) with parts = [(frame col lo, frame col hi,
    slab col lo), ...], as the JAX package defines it.
    """
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window_length, window_overlap)
    n_parts = -(-(gap + window_length) // hop)
    parts = []
    for j in range(n_parts):
        lo = max(0, j * hop - gap)
        hi = min(window_length, (j + 1) * hop - gap)
        parts.append((lo, hi, gap + lo - j * hop))
    return gap, hop, parts


def frame_signal(
    x: torch.Tensor, n_frames: int, window_length: int, window_overlap: int
) -> torch.Tensor:
    """Hop-strided overlapping windows: [n] -> [n_frames, window].

    A strided view of ``x`` (no copy) unless ``x`` is shorter than the
    frames need, in which case the tail is zero-padded as the JAX package
    pads it.
    """
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window_length, window_overlap)
    if n_frames <= 0:
        return x.new_zeros((0, window_length))
    total = gap + (n_frames - 1) * hop + window_length
    if x.shape[0] < total:
        x = torch.cat([x, x.new_zeros(total - x.shape[0])])
    return x[gap:total].unfold(0, window_length, hop)


def band_dft_matrices(
    fft_length: int,
    window_length: int,
    window_type: str = "hamming",
    bins: tuple[int, int] | None = None,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Windowed band-limited real-DFT matrices (C_re, C_im), each
    [window_length, n_bins]: ``frame @ C_re`` and ``frame @ C_im`` are the
    real and imaginary parts of DFT bins [lo, hi) of the zero-padded
    windowed frame. Built in float64 numpy, cast once."""
    lo, hi = bins if bins is not None else (0, fft_length // 2)
    w = make_window(window_type, window_length, dtype=np.float64)
    n = np.arange(window_length, dtype=np.float64)[:, None]
    k = np.arange(lo, hi, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    c_re = (w[:, None] * np.cos(ang)).astype(dtype)
    c_im = (-w[:, None] * np.sin(ang)).astype(dtype)
    return c_re, c_im


def spectral_frames(
    frames: torch.Tensor,
    fft_length: int,
    window_type: str = "hamming",
    bins: tuple[int, int] | None = None,
    kind: str = "magnitude",
    method: str = "matmul",
) -> torch.Tensor:
    """[F, window] frames -> [F, n_bins] magnitude (|X|) or power (|X|^2).

    ``method='matmul'`` is one matmul against ``[C_re | C_im]``;
    ``method='rfft'`` is a full ``torch.fft.rfft`` for cross-validation.
    """
    window_length = frames.shape[-1]
    lo, hi = bins if bins is not None else (0, fft_length // 2)
    if kind not in ("magnitude", "power"):
        raise ValueError("kind must be 'magnitude' or 'power'")
    if method == "matmul":
        c_re, c_im = band_dft_matrices(
            fft_length, window_length, window_type, (lo, hi)
        )
        c_cat = torch.from_numpy(np.concatenate([c_re, c_im], axis=1)).to(
            frames.device
        )
        big = frames @ c_cat
        b = hi - lo
        sq = big[:, :b] * big[:, :b] + big[:, b:] * big[:, b:]
    elif method == "rfft":
        w = torch.from_numpy(make_window(window_type, window_length)).to(
            frames.device
        )
        spec = torch.fft.rfft(frames * w, n=fft_length, dim=-1)[:, lo:hi]
        sq = spec.real * spec.real + spec.imag * spec.imag
    else:
        raise ValueError(f"unknown method {method!r}")
    return sq if kind == "power" else torch.sqrt(sq)


def stack_features(band: torch.Tensor, time_range: int) -> torch.Tensor:
    """[F, B] band frames -> [F - T + 1, T*B] feature vectors.

    Freq-fastest, time-major: the concatenation of ``time_range``
    consecutive frames, oldest first, advancing one frame per evaluation.
    """
    n_frames, n_bins = band.shape
    n_evals = n_frames - time_range + 1
    if n_evals <= 0:
        return band.new_zeros((0, time_range * n_bins))
    # unfold gives [E, B, T]; the feature layout wants [E, T, B]
    return (
        band.unfold(0, time_range, 1)
        .transpose(1, 2)
        .reshape(n_evals, time_range * n_bins)
    )


def frequency_index_range(
    fft_length: int, start_freq: float, end_freq: float, sample_rate: float
) -> tuple[int, int] | None:
    """Band bin range [start, end) for a frequency interval:
    start = ceil(fft/rate * f0); end = floor(fft/rate * f1) + 1 clamped to
    fft/2. None for out-of-range inputs, like the reference."""
    if not (start_freq >= 0.0 and end_freq > start_freq):
        return None
    half = fft_length // 2
    from_frequency = float(fft_length) / float(sample_rate)
    start = int(math.ceil(from_frequency * start_freq))
    if start >= half:
        return None
    end = int(math.floor(from_frequency * end_freq)) + 1
    if end < start:
        return None
    if end > half:
        return start, half
    return start, end


def frequencies_for_sample_rate(fft_length: int, sample_rate: float) -> np.ndarray:
    """Center frequency of each retained bin
    (CircularShortTimeFourierTransform.swift:160-164)."""
    half = fft_length // 2
    return np.arange(half, dtype=np.float64) * (float(sample_rate) / fft_length)
