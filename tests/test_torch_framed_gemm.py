"""The port's framed GEMM and polyphase resampler against the JAX package's.

The plain version of the framed GEMM kernel is held against the JAX Pallas
kernel (interpret mode) and against ``frame_signal @ g`` on the six
framings of tests/test_framed_gemm.py, within that file's rtol=1e-4,
atol=1e-4. The port's ``polyphase_resample`` on the CPU is held against the
JAX XLA path and the Pallas path at rtol=1e-5, atol=1e-5; its float64 plan
must be the JAX plan exactly. Interpret mode is slow, so inputs stay at or
under 9000 samples.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.kernels.framed_gemm import framed_gemm as jframed_gemm
from syllable_detector_tpu.kernels.framed_gemm import pallas_polyphase_resample
from syllable_detector_tpu.ops import resample as jresample
from syllable_detector_tpu.ops.stft import frame_signal as jframe_signal
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.ops import resample as tresample
from syllable_detector_tpu_torch.ops.stft import num_frames

# the kernels package exports the function framed_gemm under its module's
# name, as the JAX package does, so the module comes from the import system
tfg = importlib.import_module("syllable_detector_tpu_torch.kernels.framed_gemm")

torch.set_num_threads(1)


def chirp(rate: float, seconds: float = 0.09, seed: int = 5) -> np.ndarray:
    t = np.arange(int(rate * seconds)) / rate
    x = (0.5 * np.sin(2 * np.pi * 3000.0 * t)).astype(np.float32)
    return x + 0.01 * np.random.default_rng(seed).standard_normal(len(x)).astype(np.float32)


@pytest.mark.parametrize("window,overlap", fixtures.FRAMED_GEMM_GEOMETRIES)
def test_framed_gemm_reference_matches_jax(window, overlap):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(9000).astype(np.float32)
    g = rng.standard_normal((window, 24)).astype(np.float32)
    f = num_frames(9000, window, overlap)
    want_pallas = np.asarray(jframed_gemm(jnp.asarray(x), jnp.asarray(g), window, overlap, f, interpret=True))
    want = np.asarray(jframe_signal(jnp.asarray(x), f, window, overlap) @ jnp.asarray(g))
    launches = tfg.FRAMED_GEMM_LAUNCHES
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = tfg.framed_gemm_reference(xt, gt, window, overlap, f).numpy()
    # the wrapper runs the plain version for a CPU tensor, and launches nothing
    np.testing.assert_array_equal(tfg.framed_gemm(xt, gt, window, overlap, f).numpy(), got)
    assert tfg.FRAMED_GEMM_LAUNCHES == launches
    assert got.shape == want.shape == want_pallas.shape == (f, 24)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # frames past the end read zeros; no frame at all is an empty product
    tail = tfg.framed_gemm(xt[:100], gt, window, overlap, 3).numpy()
    np.testing.assert_allclose(tail, np.asarray(jframe_signal(jnp.asarray(x[:100]), 3, window, overlap) @ g), rtol=1e-5, atol=1e-5)
    assert tfg.framed_gemm(xt, gt, window, overlap, 0).shape == (0, 24)
    with pytest.raises(ValueError, match="rows"):
        tfg.framed_gemm(xt, gt[1:], window, overlap, f)


@pytest.mark.parametrize("in_rate,out_rate", fixtures.RESAMPLE_PAIRS)
def test_polyphase_resample_matches_jax(in_rate, out_rate):
    x = chirp(in_rate)
    assert len(x) <= 9000
    got = tresample.polyphase_resample(x, in_rate, out_rate, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jresample.polyphase_resample(x, in_rate, out_rate))
    want_pallas = np.asarray(pallas_polyphase_resample(x, in_rate, out_rate, interpret=True))
    assert got.shape == want.shape == want_pallas.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "up,down", [(147, 160), (160, 147), (147, 320), (441, 320), (2, 1), (1, 2), (147, 640)]
)
def test_polyphase_plan_matches_jax(up, down):
    got = tresample.polyphase_plan(up, down)
    want = jresample.polyphase_plan(up, down)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    hb, half = tresample.polyphase_filter_bank(up, down)
    jhb, jhalf = jresample.polyphase_filter_bank(up, down)
    np.testing.assert_array_equal(hb, jhb)
    assert half == jhalf


def test_polyphase_identity_and_short_input():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    y = tresample.polyphase_resample(x, 44100.0, 44100.0, device="cpu")
    np.testing.assert_array_equal(y.numpy(), x)
    # a ratio that limit_denominator rounds to 1 is the identity too, as in JAX
    y = tresample.polyphase_resample(x, 44100.0, 44100.01, device="cpu")
    np.testing.assert_array_equal(y.numpy(), np.asarray(jresample.polyphase_resample(x, 44100.0, 44100.01)))
    # inputs shorter than one window: every frame is mostly zero padding
    for n in (1, 7, 150):
        got = tresample.polyphase_resample(x[:n], 48000.0, 44100.0, device="cpu").numpy()
        want = np.asarray(jresample.polyphase_resample(x[:n], 48000.0, 44100.0))
        assert got.shape == want.shape == (-(-n * 147 // 160),)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    cases = [(w, o, 24) for w, o in fixtures.FRAMED_GEMM_GEOMETRIES]
    for in_rate, out_rate in fixtures.RESAMPLE_PAIRS:
        frac = tresample.Fraction(out_rate / in_rate).limit_denominator(1000)
        _, _, w_len, overlap = tresample.polyphase_plan(frac.numerator, frac.denominator)
        cases.append((w_len, overlap, frac.numerator))
    for window, overlap, m in cases:
        x = torch.from_numpy(rng.standard_normal(90000).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.standard_normal((window, m)).astype(np.float32)).cuda()
        f = num_frames(90000, window, overlap) + 5  # a zero-padded tail
        launches = tfg.FRAMED_GEMM_LAUNCHES
        got = tfg.framed_gemm(x, g, window, overlap, f)
        torch.cuda.synchronize()
        assert tfg.FRAMED_GEMM_LAUNCHES == launches + 1
        want = tfg.framed_gemm_reference(x, g, window, overlap, f)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the kernel's tiling and the zero band of G it skips
# ---------------------------------------------------------------------------


def resampler_g(in_rate, out_rate):
    frac = tresample.Fraction(out_rate / in_rate).limit_denominator(1000)
    g, _, w_len, overlap = tresample.polyphase_plan(frac.numerator, frac.denominator)
    return torch.from_numpy(g), w_len, overlap


def sequential_product(frames: np.ndarray, g: np.ndarray, lo: int = 0, hi=None) -> np.ndarray:
    """``frames[:, lo:hi] @ g[lo:hi]`` summed over k in ascending order in
    float32, one product and one sum per step, as a thread of the kernel
    walks its rows."""
    acc = np.zeros((frames.shape[0], g.shape[1]), np.float32)
    with np.errstate(invalid="ignore"):  # a test feeds NaN and Inf on purpose
        for k in range(lo, g.shape[0] if hi is None else hi):
            acc = acc + frames[:, k, None] * g[None, k, :]
    return acc


def banded_product(x, g, window, overlap, n_frames):
    """The kernel's sums in plain PyTorch: for each column tile only the
    rows of its band, read through the kernel's own layout of the bands."""
    from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length

    cut = tfg.tiling(window, g.shape[1], hop_length(window, overlap))
    bands = tfg.column_bands(g, cut.cw)
    band, ranges = tfg.band_layout(g, bands, cut.cg)
    frames = frame_signal(x, n_frames, window, overlap)
    frames = torch.cat([frames, frames.new_zeros((n_frames, 8))], dim=1)
    out = torch.zeros((n_frames, cut.n_tiles * cut.cw))
    for t, (lo4, n) in enumerate(ranges.tolist()):
        # band[t, r, ci*4 + j] is column t*cw + j*cg + ci
        tile = band[t, :n].reshape(n, cut.cg, 4).transpose(1, 2).reshape(n, cut.cw)
        out[:, t * cut.cw : (t + 1) * cut.cw] = torch.from_numpy(
            sequential_product(frames[:, lo4 : lo4 + n].numpy(), tile.numpy())
        )
    return out[:, : g.shape[1]], cut, bands, ranges


@pytest.mark.parametrize("in_rate,out_rate", fixtures.RESAMPLE_PAIRS)
def test_band_restricted_product_is_the_dense_product(in_rate, out_rate):
    g, window, overlap = resampler_g(in_rate, out_rate)
    x = torch.from_numpy(chirp(in_rate, seconds=0.05))
    n_frames = min(40, num_frames(len(x), window, overlap) + 2)
    got, cut, bands, ranges = banded_product(x, g, window, overlap, n_frames)
    # every row outside a tile's range is zero in all of the tile's columns
    for t, (lo, hi) in enumerate(bands):
        cols = g[:, t * cut.cw : (t + 1) * cut.cw]
        assert not cols[:lo].any() and not cols[hi:].any()
        assert cols[lo].any() and cols[hi - 1].any()
        lo4, n = ranges[t].tolist()
        assert lo4 % 4 == 0 and n % 4 == 0 and lo4 <= lo and hi <= lo4 + n <= window + 3
    from syllable_detector_tpu_torch.ops.stft import frame_signal

    frames = frame_signal(x, n_frames, window, overlap).numpy()
    # summed in the same order, the skipped rows add exact zeros: bit for bit
    np.testing.assert_array_equal(got.numpy(), sequential_product(frames, g.numpy()))
    want = tfg.framed_gemm_reference(x, g, window, overlap, n_frames).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if g.shape[1] > 32:  # the resampler's band: a tile sums over a fraction of G
        assert max(n for _, n in ranges.tolist()) < 0.4 * window


def test_dense_g_keeps_every_row():
    rng = np.random.default_rng(4)
    for window, overlap in fixtures.FRAMED_GEMM_GEOMETRIES:
        g = torch.from_numpy(rng.standard_normal((window, 24)).astype(np.float32))
        cut = tfg.tiling(window, 24, window - overlap)
        assert tfg.column_bands(g, cut.cw) == [(0, window)] * cut.n_tiles
        x = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
        got, *_ = banded_product(x, g, window, overlap, 9)
        want = tfg.framed_gemm_reference(x, g, window, overlap, 9).numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # a tile of zeros sums over nothing; G's non-zeros are found wherever they are
    g = torch.zeros((20, 40))
    g[7, 33] = 1.0
    g[12, 39] = float("nan")
    assert tfg.column_bands(g, 32) == [(0, 0), (7, 13)]
    band, ranges = tfg.band_layout(g, [(0, 0), (7, 13)], 8)
    assert ranges.tolist() == [[0, 0], [4, 12]] and band.shape == (2, 12, 32)
    assert band[0].abs().sum() == 0 and band[1, 3, (33 - 32) % 8 * 4 + (33 - 32) // 8] == 1.0


@pytest.mark.parametrize(
    "window,m,hop",
    [(181, 147, 160), (167, 160, 147), (362, 147, 320), (340, 441, 320), (21, 2, 1)]
    + [(w, 24, w - o) for w, o in fixtures.FRAMED_GEMM_GEOMETRIES],
)
def test_tiling_of_the_paths_shapes(window, m, hop):
    cut = tfg.tiling(window, m, hop)
    assert cut.cw == 4 * cut.cg and cut.cg in (1, 2, 4, 8)
    assert cut.n_tiles * cut.cw >= m > (cut.n_tiles - 1) * cut.cw
    unit = 8 * 32 // cut.cg
    assert cut.frames % unit == 0 and cut.frames >= unit
    assert 32 <= cut.threads <= 256 and cut.threads % 32 == 0
    units = cut.n_tiles * cut.frames // unit
    if cut.ksplit > 1:  # one warp per part of each unit, parts of 16 rows or more
        assert cut.threads // 32 == units * cut.ksplit <= 4 and window // cut.ksplit >= 16
    else:
        assert cut.threads // 32 <= units and (units >= 3 or window < 32)
    assert cut.vec == (hop % 4 == 0)
    assert cut.span_bytes == 4 * (-(-((cut.frames - 1) * hop + window + 8) // 4) * 4)
    assert cut.span_bytes <= tfg.SMEM_LIMIT
    # more than one unit of frames only while the span stays small
    assert cut.frames == unit or cut.span_bytes <= tfg.SPAN_TARGET


def test_tiling_of_the_resampler_and_its_limits():
    # (cg, cw, column tiles, frames a CTA, warps a unit, threads)
    assert tfg.tiling(181, 147, 160)[:6] == (8, 32, 5, 32, 1, 128)  # 48k -> 44.1k
    assert tfg.tiling(362, 147, 320)[:6] == (8, 32, 5, 32, 1, 128)  # 96k -> 44.1k
    assert tfg.tiling(340, 441, 320)[:6] == (8, 32, 14, 32, 1, 256)  # 32k -> 44.1k
    assert tfg.tiling(21, 2, 1)[:6] == (1, 4, 1, 2048, 1, 256)  # 22.05k -> 44.1k
    # a narrow G at a long hop leaves a CTA one or two units: rows split over warps
    assert tfg.tiling(256, 24, 132)[:6] == (8, 32, 1, 32, 4, 128)
    assert tfg.tiling(300, 24, 64)[:6] == (8, 32, 1, 64, 2, 128)
    assert tfg.tiling(40, 24, 256)[:6] == (8, 32, 1, 32, 2, 64)  # parts of 16 rows at least
    with pytest.raises(ValueError, match="stages"):
        tfg.tiling(60000, 24, 30000)


def test_non_finite_samples_follow_the_dense_product():
    """What the wrapper documents: 0 * NaN is NaN, so the plain version has
    NaN in every column of a frame that holds a NaN, and for an Inf wherever
    G has a zero in that row; summing over a tile's band alone would not."""
    g, window, overlap = resampler_g(48000.0, 44100.0)
    hop = window - overlap
    x = torch.from_numpy(chirp(48000.0, seconds=0.05))
    n_frames = 12
    nan_at, inf_at = 3 * hop + 5, 9 * hop + 10
    x[nan_at], x[inf_at] = float("nan"), float("inf")
    want = tfg.framed_gemm_reference(x, g, window, overlap, n_frames)
    assert tfg.framed_gemm(x, g, window, overlap, n_frames).isnan().equal(want.isnan())
    rows = lambda at: [f for f in range(n_frames) if f * hop <= at < f * hop + window]
    assert rows(nan_at) == [2, 3] and rows(inf_at) == [8, 9]
    for f in rows(nan_at):
        assert want[f].isnan().all()
    for f in rows(inf_at):
        zero = g[inf_at - f * hop] == 0
        assert want[f][zero].isnan().all() and want[f][~zero].isinf().all() and zero.any()
    clean = [f for f in range(n_frames) if f not in rows(nan_at) + rows(inf_at)]
    assert want[clean].isfinite().all()
    banded, *_ = banded_product(x, g, window, overlap, n_frames)
    assert banded[rows(nan_at)].isfinite().any()  # the skip alone would lose NaN
    np.testing.assert_allclose(banded[clean].numpy(), want[clean].numpy(), rtol=1e-5, atol=1e-6)
