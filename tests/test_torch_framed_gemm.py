"""The port's framed GEMM and polyphase resampler against the JAX package's.

The plain version of the framed GEMM kernel is held against the JAX Pallas
kernel (interpret mode) and against ``frame_signal @ g`` on the six
framings of tests/test_framed_gemm.py, within that file's rtol=1e-4,
atol=1e-4. The port's ``polyphase_resample`` on the CPU is held against the
JAX XLA path and the Pallas path at rtol=1e-5, atol=1e-5; its float64 plan
must be the JAX plan exactly. The kernel's two launches are checked from
their tilings, and the band launch's sums by a numpy emulation held bit for
bit against an in-order sum, and against the JAX kernel at the resampler's
1e-5 / 1e-5. Interpret mode is slow, so inputs stay at or under 9000
samples.
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


def banded_product(x, g, window, overlap, n_frames, quads=False):
    """The kernel's sums in plain PyTorch: for each column tile (at the run
    form's and the band launch's width) or, with ``quads``, each column
    quad (the slot form's bands, in the long launch's groups) only the rows
    of its band, read through the kernel's own layout of the bands, in
    ascending order. Returns (the product, columns a band, bands, ranges)."""
    from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length

    m = g.shape[1]
    if quads:  # grouped as the slot form groups them, one quad a group where it does not apply
        cut = tfg.slot_tiling(window, m, hop_length(window, overlap))
        cw, cg, bands = 4, 1, tfg.quad_bands(g, cut.cg if cut else 1)
    else:
        cw, cg = tfg._column_group(m)
        bands = tfg.column_bands(g, cw)
    band, ranges = tfg.band_layout(g, bands, cg)
    frames = frame_signal(x, n_frames, window, overlap)
    frames = torch.cat([frames, frames.new_zeros((n_frames, 8))], dim=1)
    out = torch.zeros((n_frames, len(bands) * cw))
    for t, (lo4, n) in enumerate(ranges.tolist()):
        # band[t, r, ci*4 + j] is column t*cw + j*cg + ci
        tile = band[t, :n].reshape(n, cg, 4).transpose(1, 2).reshape(n, cw)
        out[:, t * cw : (t + 1) * cw] = torch.from_numpy(
            sequential_product(frames[:, lo4 : lo4 + n].numpy(), tile.numpy())
        )
    return out[:, :m], cw, bands, ranges


@pytest.mark.parametrize("in_rate,out_rate", fixtures.RESAMPLE_PAIRS)
def test_band_restricted_product_is_the_dense_product(in_rate, out_rate):
    g, window, overlap = resampler_g(in_rate, out_rate)
    x = torch.from_numpy(chirp(in_rate, seconds=0.05))
    n_frames = min(40, num_frames(len(x), window, overlap) + 2)
    got, cw, bands, ranges = banded_product(x, g, window, overlap, n_frames)
    # every row outside a tile's range is zero in all of the tile's columns
    for t, (lo, hi) in enumerate(bands):
        cols = g[:, t * cw : (t + 1) * cw]
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
        cw, _ = tfg._column_group(24)
        assert tfg.column_bands(g, cw) == [(0, window)] * -(-24 // cw)
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
    assert cut.threads % 32 == 0 and not cut.band
    stride = -(-window // 4) * 4
    stride += 0 if stride // 4 % 2 else 4
    assert cut.slots == (stride <= tfg.SLOT_HOPS * hop)
    if cut.slots:
        # one unit of frames a block: fpt frames a lane by 32 / cg lanes
        assert cut.frames == cut.fpt * 32 // cut.cg and cut.fpt in tfg.SLOT_FRAMES
        assert cut.stride == stride and cut.vec and cut.span_bytes == 2 * 4 * cut.frames * stride
        assert 32 <= cut.threads <= 32 * tfg.MAX_SLOT_WARPS
        red = cut.threads * cut.fpt * 4 if cut.ksplit > 1 else 0
        assert cut.span_bytes + 4 * red <= tfg.SMEM_LIMIT
        assert cut.per_sm >= 1 and cut.per_sm * (cut.span_bytes + 4 * red + 1024) <= tfg.SMEM_SM
        if cut.ksplit > 1:  # one warp per part of each group of quads
            assert cut.threads // 32 == cut.n_tiles * cut.ksplit <= tfg.MAX_SLOT_WARPS
            assert window // cut.ksplit >= tfg.MIN_SLOT_PART_ROWS
        else:  # the groups spread evenly over the warps
            rounds = -(-cut.n_tiles // (cut.threads // 32))
            assert cut.n_tiles > (rounds - 1) * cut.threads // 32
        # an idle quad slot of a warp is at most a quarter of the quads
        quads = -(-m // 4)
        assert 4 * (cut.n_tiles * cut.cg - quads) <= quads or cut.cg == 1
        return
    unit = 8 * 32 // cut.cg
    assert cut.frames % unit == 0 and cut.frames >= unit
    assert 32 <= cut.threads <= 256
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
    # the long launch's slot form: (quads a warp, columns a warp, groups of
    # quads, frames a block, warps a group, threads), frames a lane
    assert tfg.tiling(181, 147, 160)[:6] == (4, 16, 10, 16, 1, 320)  # 48k -> 44.1k
    assert tfg.tiling(362, 147, 320)[:6] == (4, 16, 10, 16, 1, 320)  # 96k -> 44.1k
    assert tfg.tiling(1254, 53, 923)[:6] == (4, 16, 4, 16, 4, 512)  # 192k -> 11.025k
    cut = tfg.tiling(2891, 147, 2560)  # 192k -> 11.025k at the exact ratio
    assert cut[:6] == (4, 16, 10, 8, 1, 320) and cut.fpt == 1 and cut.stride == 2892
    # a shallow band (28 rows) over 111 quads: the run form; over 37 quads
    # with slots of 1.2 hops, still the slot form
    assert tfg.tiling(340, 441, 320, depth=28)[:6] == (8, 32, 14, 32, 1, 256)  # 32k -> 44.1k
    assert tfg.tiling(181, 147, 160, depth=28).slots
    assert tfg.tiling(21, 2, 1)[:6] == (1, 4, 1, 2048, 1, 256)  # 22.05k -> 44.1k, run form
    # the run form (the long launch before the slot form): a narrow G at a
    # long hop leaves a CTA one or two units, its rows split over warps
    assert tfg._run_tiling(181, 147, 160)[:6] == (8, 32, 5, 32, 1, 128)
    assert tfg._run_tiling(340, 441, 320)[:6] == (8, 32, 14, 32, 1, 256)
    assert tfg._run_tiling(256, 24, 132)[:6] == (8, 32, 1, 32, 4, 128)
    assert tfg._run_tiling(300, 24, 64)[:6] == (8, 32, 1, 64, 2, 128)
    assert tfg._run_tiling(40, 24, 256)[:6] == (8, 32, 1, 32, 2, 64)  # parts of 16 rows at least
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


# ---------------------------------------------------------------------------
# the launch for a short channel: column tiles on the grid, each CTA staging
# its tile's band alone (the band launch)
# ---------------------------------------------------------------------------

# the six pairs where the long launch lost most to ``unfold @ g`` on 5 s
# channels, and two of the corpus scan's pairs into the sample net's rate
SHORT_CHANNEL_PAIRS = [
    (48000.0, 11025.0), (192000.0, 11025.0), (44100.0, 8000.0), (22050.0, 8000.0),
    (96000.0, 11025.0), (96000.0, 22050.0), (48000.0, 44100.0), (96000.0, 44100.0),
]


def pair_framing(in_rate, out_rate, seconds, denominator=1000):
    """(window, columns, hop, frames, the column tiles' row ranges, the
    deepest column quad's band) of the resampler's product on a channel of
    ``seconds``, as the wrapper sees them."""
    from syllable_detector_tpu_torch.ops.stft import hop_length

    x = np.zeros(int(seconds * in_rate), np.float32)
    _, g, window, overlap, blocks, _ = tresample.polyphase_framing(
        x, in_rate, out_rate, max_denominator=denominator, device="cpu")
    cw, cg = tfg._column_group(g.shape[1])
    _, ranges = tfg.band_layout(g, tfg.column_bands(g, cw), cg)
    depth = max(hi - lo // 4 * 4 for lo, hi in tfg.column_bands(g, 4))
    return (window, g.shape[1], hop_length(window, overlap), blocks,
            [tuple(r) for r in ranges.tolist()], -(-depth // 4) * 4)


@pytest.mark.parametrize(
    "in_rate,out_rate,seconds",
    [(a, b, 5.0) for a, b in SHORT_CHANNEL_PAIRS] + [(48000.0, 44100.0, 60.0), (96000.0, 44100.0, 60.0)],
)
def test_launch_by_channel_length(in_rate, out_rate, seconds):
    window, m, hop, blocks, ranges, depth = pair_framing(in_rate, out_rate, seconds)
    long = tfg.tiling(window, m, hop)
    assert long == tfg.long_tiling(window, m, hop) and not long.band
    run = tfg._run_tiling(window, m, hop)  # the band rule counts the run form's CTAs
    cut = tfg.tiling(window, m, hop, n_frames=blocks, sms=132, ranges=ranges, depth=depth)
    if seconds == 60.0:  # the corpus scan's 60 s channels: the long launch's slot form
        assert cut == tfg.long_tiling(window, m, hop, blocks, 132, depth) and cut.slots
        assert tfg.launch_ctas(run, blocks) >= 2 * 132
        assert tfg.launch_ctas(cut, blocks, 132) == cut.per_sm * 132 < -(-blocks // cut.frames)
        return
    # a 5 s channel: the long launch leaves most SMs idle; the band launch
    # puts G's column tiles on the grid and reaches an SM's worth of CTAs
    assert tfg.launch_ctas(run, blocks) < 2 * 132
    assert cut.band and cut.n_tiles == run.n_tiles > 1 and cut.fpt == tfg.BAND_FRAMES
    assert tfg.launch_ctas(cut, blocks) >= 132
    assert cut.frames == cut.fpt * 32 // cut.cg
    # a CTA takes a group of neighbouring tiles and stages their bands' rows
    group = [(lo, n) for lo, n in ranges[: cut.group] if n]
    assert cut.rows >= max(lo + n for lo, n in group) - min(lo for lo, _ in group)
    assert cut.rows <= max(n for _, n in ranges) * cut.group
    if cut.ksplit > 1:  # one warp per (tile, part of its rows), parts of 16 rows or more
        assert cut.threads == 32 * cut.group * cut.ksplit <= 256
        assert max(n for _, n in ranges) // cut.ksplit >= tfg.MIN_PART_ROWS
    else:
        assert cut.threads == 32 * min(cut.group, tfg.MAX_WARPS)
    # frame by frame where the hop leaves gaps between the staged rows
    if hop >= cut.stride:
        assert cut.stride >= cut.rows and cut.stride % 8 == 4 and cut.vec
        assert cut.span_bytes == 4 * cut.frames * cut.stride
        assert cut.span_bytes < run.span_bytes
    else:
        assert cut.stride == hop


@pytest.mark.parametrize("in_rate,out_rate", SHORT_CHANNEL_PAIRS + [(8000.0, 16000.0)])
def test_band_launch_rule_on_long_channels(in_rate, out_rate):
    """On a 60 s channel the band launch is taken only where the long
    launch's run form leaves SMs idle (fewer than one CTA an SM over
    several column tiles, half of one over one tile, twice that for a band
    of 64 rows or more), in the fewest groups of column tiles that fill the
    card; else the long launch, in its slot or run form."""
    window, m, hop, blocks, ranges, depth = pair_framing(in_rate, out_rate, 60.0)
    long = tfg.long_tiling(window, m, hop, blocks, 132, depth)
    run = tfg._run_tiling(window, m, hop)
    cut = tfg.tiling(window, m, hop, n_frames=blocks, sms=132, ranges=ranges, depth=depth)
    ctas = tfg.launch_ctas(run, blocks)
    idle = (132 if run.n_tiles > 1 else 66) * (2 if max(n for _, n in ranges) >= 64 else 1)
    if ctas >= idle:
        assert cut == long
    else:
        assert cut.band and tfg.launch_ctas(cut, blocks) >= 2 * 132
        fewer = -(-run.n_tiles // cut.group) - 1
        assert fewer == 0 or -(-blocks // cut.frames) * fewer < 2 * 132
    # a card of one SM is filled by the long launch
    assert tfg.tiling(window, m, hop, n_frames=blocks, sms=1, ranges=ranges,
                      depth=depth) == tfg.long_tiling(window, m, hop, blocks, 1, depth)


def band_launch_product(x: np.ndarray, g: np.ndarray, window: int, overlap: int,
                        n_frames: int, cut) -> np.ndarray:
    """The band launch's arithmetic in numpy float32, CTA by CTA: a CTA of
    ``cut.frames`` frames (and any group of column tiles) whose span
    ((frames - 1) * hop + window + 8 samples, zero past the end) holds a NaN
    or an Inf sums all of G's rows; else each column tile only its band's
    rows [lo4, lo4 + rows), read at the samples' own positions. With
    ``cut.ksplit`` parts, each part sums its rows in ascending order and the
    parts are then added in order."""
    from syllable_detector_tpu_torch.ops.stft import hop_length, normalize_overlap

    gap, _ = normalize_overlap(overlap)
    hop = hop_length(window, overlap)
    m = g.shape[1]
    ks, frames_a_cta = cut.ksplit, cut.frames
    _, ranges = tfg.band_layout(torch.from_numpy(g), tfg.column_bands(torch.from_numpy(g), cut.cw),
                                cut.cg)
    n = len(x)
    blocks = -(-n_frames // frames_a_cta)
    span = -(-((frames_a_cta - 1) * hop + window + 8) // 4) * 4
    padded = np.concatenate([x, np.zeros(gap + blocks * frames_a_cta * hop + span, np.float32)])
    gpad = np.zeros((window + 4, cut.n_tiles * cut.cw), np.float32)
    gpad[:window, :m] = g
    out = np.zeros((blocks * frames_a_cta, cut.n_tiles * cut.cw), np.float32)
    rows_of = np.arange(window + 4)
    for fb in range(blocks):
        start = gap + fb * frames_a_cta * hop
        dense = not np.isfinite(padded[start : min(start + span, max(n, start))]).all()
        frames = np.stack([padded[start + f * hop + rows_of] for f in range(frames_a_cta)])
        for t, (lo4, rows) in enumerate(ranges.tolist()):
            cols = gpad[:, t * cut.cw : (t + 1) * cut.cw]
            if dense:
                lo, hi, chunk = 0, window, -(-window // ks)
            else:
                lo, hi, chunk = lo4, lo4 + rows, -(-(-(-rows // ks)) // 4) * 4
            parts = [sequential_product(frames, cols, min(hi, lo + p * chunk), min(hi, lo + (p + 1) * chunk))
                     for p in range(ks)]
            total = parts[0]
            with np.errstate(invalid="ignore"):
                for part in parts[1:]:
                    total = total + part
            out[fb * frames_a_cta : (fb + 1) * frames_a_cta, t * cut.cw : (t + 1) * cut.cw] = total
    return out[:n_frames, :m]


@pytest.mark.parametrize("in_rate,out_rate", SHORT_CHANNEL_PAIRS)
def test_band_launch_arithmetic(in_rate, out_rate):
    """The band launch's sums: without a row split, bit for bit the dense
    product summed in order (a skipped row adds an exact zero); with the
    rule's row split, the JAX kernel's product within the resampler's
    tolerance."""
    from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length

    g, window, overlap = resampler_g(in_rate, out_rate)
    hop = hop_length(window, overlap)
    x = chirp(in_rate, seconds=min(0.09, 8900 / in_rate))
    n_frames = num_frames(len(x), window, overlap) + 2  # a zero-padded tail
    gn = g.numpy()
    long = tfg.long_tiling(window, g.shape[1], hop)
    _, ranges = tfg.band_layout(g, tfg.column_bands(g, long.cw), long.cg)
    cut = tfg.band_tiling(window, g.shape[1], hop, n_frames, 132, [tuple(r) for r in ranges.tolist()])
    assert cut.band and cut.ksplit > 1  # the resampler's bands are deep enough to split
    frames = frame_signal(torch.from_numpy(x), n_frames, window, overlap).numpy()
    unsplit = band_launch_product(x, gn, window, overlap, n_frames, cut._replace(ksplit=1))
    np.testing.assert_array_equal(unsplit, sequential_product(frames, gn))
    got = band_launch_product(x, gn, window, overlap, n_frames, cut)
    want = np.asarray(jframed_gemm(jnp.asarray(x), jnp.asarray(gn), window, overlap, n_frames,
                                   interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, tfg.framed_gemm_reference(
        torch.from_numpy(x), g, window, overlap, n_frames).numpy(), rtol=1e-5, atol=1e-5)


def test_band_launch_sees_non_finite_samples_outside_its_band():
    """A NaN in a frame's window but outside a tile's band: the band
    launch's CTA stages only the band, yet its scan of the whole span sends
    it to the dense sums, so NaN falls where the plain version has it."""
    from syllable_detector_tpu_torch.ops.stft import hop_length

    g, window, overlap = resampler_g(48000.0, 11025.0)
    hop = hop_length(window, overlap)
    gn = g.numpy()
    x = chirp(48000.0, seconds=0.18)
    n_frames = num_frames(len(x), window, overlap)
    cut = tfg.band_tiling(window, g.shape[1], hop, n_frames)
    bands = tfg.column_bands(g, cut.cw)
    # frame 3's row r lies outside tile 0's band and inside the window
    lo, hi = bands[0]
    row = hi + 40
    assert row < window and not (lo <= row < hi)
    at = 3 * hop + row
    x[at] = np.float32("nan")
    want = tfg.framed_gemm_reference(torch.from_numpy(x), g, window, overlap, n_frames).numpy()
    holds = [f for f in range(n_frames) if f * hop <= at < f * hop + window]
    assert holds and all(np.isnan(want[f]).all() for f in holds)
    got = band_launch_product(x, gn, window, overlap, n_frames, cut)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)
    # without the scan, tile 0's columns of those frames would stay finite
    frames = np.stack([np.concatenate([x, np.zeros(window + 8, np.float32)])[f * hop + np.arange(window)]
                       for f in holds])
    lo4 = lo // 4 * 4
    band_only = sequential_product(frames, gn[:, : cut.cw], lo4, min(window, hi))
    assert np.isfinite(band_only).all()


# ---------------------------------------------------------------------------
# the long launch's slot form: each frame staged in a slot, a lane summing
# over its column quad's band
# ---------------------------------------------------------------------------

# the six 60 s pairs where the run form lost to ``unfold @ g``, and the
# exact 192k -> 11.025k ratio (max_denominator 10**6)
LONG_HOP_PAIRS = [
    (192000.0, 11025.0, 1000), (192000.0, 22050.0, 1000), (176400.0, 16000.0, 1000),
    (192000.0, 44100.0, 1000), (96000.0, 22050.0, 1000), (176400.0, 32000.0, 1000),
    (192000.0, 11025.0, 10**6),
]


def resampler_plan(in_rate, out_rate, denominator=1000):
    frac = tresample.Fraction(out_rate / in_rate).limit_denominator(denominator)
    g, _, w_len, overlap = tresample.polyphase_plan(frac.numerator, frac.denominator)
    return torch.from_numpy(g), w_len, overlap


def slot_launch_product(x: np.ndarray, g: np.ndarray, window: int, overlap: int,
                        n_frames: int, cut) -> np.ndarray:
    """The slot form's arithmetic in numpy float32, block by block: a block
    of ``cut.frames`` frames whose slots (``cut.stride`` samples from each
    frame's first, zero past the end) hold a NaN or an Inf sums all of G's
    rows; else each column quad only its band's rows (``quad_bands`` at
    ``cut.cg``). With ``cut.ksplit`` parts, each part sums its rows in
    ascending order and the parts are then added in order."""
    from syllable_detector_tpu_torch.ops.stft import hop_length, normalize_overlap

    gap, _ = normalize_overlap(overlap)
    hop = hop_length(window, overlap)
    m = g.shape[1]
    ks = cut.ksplit
    _, ranges = tfg.band_layout(torch.from_numpy(g), tfg.quad_bands(torch.from_numpy(g), cut.cg), 1)
    blocks = -(-n_frames // cut.frames)
    padded = np.concatenate([x, np.zeros(gap + blocks * cut.frames * hop + cut.stride, np.float32)])
    n_quads = -(-m // 4)
    gpad = np.zeros((cut.stride, 4 * n_quads), np.float32)
    gpad[:window, :m] = g
    out = np.zeros((blocks * cut.frames, 4 * n_quads), np.float32)
    for b in range(blocks):
        starts = [gap + (b * cut.frames + f) * hop for f in range(cut.frames)]
        slots = np.stack([np.where(s + np.arange(cut.stride) < len(x), padded[s : s + cut.stride], 0)
                          for s in starts]).astype(np.float32)
        dense = not np.isfinite(slots).all()
        for q, (lo, rows) in enumerate(ranges.tolist()):
            cols = gpad[:, 4 * q : 4 * q + 4]
            if dense:
                lo, hi, chunk = 0, window, -(-window // ks)
            else:
                hi, chunk = lo + rows, -(-(-(-rows // ks)) // 4) * 4
            parts = [sequential_product(slots, cols, min(hi, lo + p * chunk), min(hi, lo + (p + 1) * chunk))
                     for p in range(ks)]
            total = parts[0]
            with np.errstate(invalid="ignore"):
                for part in parts[1:]:
                    total = total + part
            out[b * cut.frames : (b + 1) * cut.frames, 4 * q : 4 * q + 4] = total
    return out[:n_frames, :m]


@pytest.mark.parametrize(
    "in_rate,out_rate,denominator",
    [(a, b, 1000) for a, b in fixtures.RESAMPLE_PAIRS] + LONG_HOP_PAIRS,
)
def test_quad_bands_sum_is_the_dense_product(in_rate, out_rate, denominator):
    """A column quad's band, in the slot form's groups, summed in ascending
    order, adds exact zeros where it passes G's zeros: bit for bit the
    dense product summed in order, and the plain version within 1e-5 /
    1e-6; at the long hops it does at most 1.25 multiply-adds for each
    non-zero of G (the column tiles' bands did 2.6-3.1)."""
    from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length

    g, window, overlap = resampler_plan(in_rate, out_rate, denominator)
    hop = hop_length(window, overlap)
    cut = tfg.slot_tiling(window, g.shape[1], hop)
    cg = cut.cg if cut else 1
    assert (cut is not None) == tfg.long_tiling(window, g.shape[1], hop).slots
    x = torch.from_numpy(chirp(in_rate, seconds=min(0.05, 8900 / in_rate)))
    n_frames = num_frames(len(x), window, overlap) + 2  # a zero-padded tail
    got, _, _, ranges = banded_product(x, g, window, overlap, n_frames, quads=True)
    frames = frame_signal(x, n_frames, window, overlap).numpy()
    np.testing.assert_array_equal(got.numpy(), sequential_product(frames, g.numpy()))
    want = tfg.framed_gemm_reference(x, g, window, overlap, n_frames).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # each quad's band holds every non-zero row of its columns, within the
    # window rounded up to 4; the quads of a warp's group are as deep
    w4 = -(-window // 4) * 4
    own = tfg.column_bands(g, 4)
    for q, ((lo, hi), (lo4, n)) in enumerate(zip(own, ranges.tolist())):
        assert lo4 % 4 == 0 and n % 4 == 0 and 0 <= lo4 and lo4 + n <= w4
        assert hi <= lo or lo4 <= lo < hi <= lo4 + n
        group = ranges.tolist()[q // cg * cg : (q // cg + 1) * cg]
        assert {r for _, r in group} == {n}
    macs = 4 * sum(n for _, n in ranges.tolist())
    # the column tiles' bands at the run form's width
    tile_macs = sum(-(-(hi - lo // 4 * 4) // 4) * 4 * 32 for lo, hi in tfg.column_bands(g, 32))
    nnz = int(torch.count_nonzero(g))
    assert macs < tile_macs
    if (in_rate, out_rate, denominator) in LONG_HOP_PAIRS:
        assert macs <= 1.25 * nnz and tile_macs >= 2.5 * nnz


@pytest.mark.parametrize("in_rate,out_rate,denominator", LONG_HOP_PAIRS + [
    (48000.0, 44100.0, 1000), (96000.0, 44100.0, 1000), (32000.0, 44100.0, 1000)])
def test_slot_launch_arithmetic(in_rate, out_rate, denominator):
    """The slot form's sums, block by block: without a row split, bit for
    bit the dense product summed in order, the run form's (the long launch
    of before) result; with the rule's row split, the plain version within
    1e-5 / 1e-6."""
    from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length

    g, window, overlap = resampler_plan(in_rate, out_rate, denominator)
    hop = hop_length(window, overlap)
    cut = tfg.long_tiling(window, g.shape[1], hop)
    assert cut.slots and cut.frames == cut.fpt * 32 // cut.cg
    x = chirp(in_rate, seconds=min(0.09, 8900 / in_rate))
    n_frames = num_frames(len(x), window, overlap) + 3
    gn = g.numpy()
    frames = frame_signal(torch.from_numpy(x), n_frames, window, overlap).numpy()
    unsplit = slot_launch_product(x, gn, window, overlap, n_frames, cut._replace(ksplit=1))
    np.testing.assert_array_equal(unsplit, sequential_product(frames, gn))
    got = slot_launch_product(x, gn, window, overlap, n_frames, cut)
    want = tfg.framed_gemm_reference(torch.from_numpy(x), g, window, overlap, n_frames).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_slot_launch_sees_non_finite_samples_outside_a_band():
    """A NaN in a frame's window outside most quads' bands: the slot form
    checks all of a block's slots, so the block sums all of G's rows and
    NaN falls where the plain version has it (every column of the frames
    that hold it); an Inf gives NaN where G has a zero, as there."""
    from syllable_detector_tpu_torch.ops.stft import hop_length

    g, window, overlap = resampler_plan(192000.0, 11025.0)
    hop = hop_length(window, overlap)
    cut = tfg.long_tiling(window, g.shape[1], hop)
    gn = g.numpy()
    x = chirp(192000.0, seconds=0.3)
    n_frames = num_frames(len(x), window, overlap)
    nan_at = 20 * hop + 5
    inf_at = 3 * hop + 500
    x[nan_at], x[inf_at] = np.float32("nan"), np.float32("inf")
    want = tfg.framed_gemm_reference(torch.from_numpy(x), g, window, overlap, n_frames).numpy()
    got = slot_launch_product(x, gn, window, overlap, n_frames, cut)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-6)
    holds = [f for f in range(n_frames) if f * hop <= nan_at < f * hop + window]
    assert holds == [19, 20] and all(np.isnan(want[f]).all() for f in holds)
    # the quads' bands alone would leave most of those columns finite
    banded, *_ = banded_product(torch.from_numpy(x), g, window, overlap, n_frames, quads=True)
    assert all(np.isfinite(banded.numpy()[f]).sum() > g.shape[1] // 2 for f in holds)


def test_dense_g_keeps_every_row_of_every_quad():
    """``quad_bands`` of a dense G is the whole window (rounded up to 4) for
    every quad; a group of zero quads sums over nothing; a NaN in G counts
    as a non-zero; ``band_layout`` lays a quad's 4 columns side by side."""
    rng = np.random.default_rng(4)
    for window, overlap in fixtures.FRAMED_GEMM_GEOMETRIES:
        g = torch.from_numpy(rng.standard_normal((window, 24)).astype(np.float32))
        hop = window - overlap
        w4 = -(-window // 4) * 4
        for cg in (1, 2, 4):
            assert tfg.quad_bands(g, cg) == [(0, w4)] * 6
        if tfg.long_tiling(window, 24, hop).slots:
            x = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
            got, *_ = banded_product(x, g, window, overlap, 9, quads=True)
            want = tfg.framed_gemm_reference(x, g, window, overlap, 9).numpy()
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    g = torch.zeros((20, 40))
    g[7, 33] = 1.0
    g[12, 39] = float("nan")
    g[2, 5] = 2.0
    # at cg 4, quad 1's band [0, 4) sets the depth of quads 0-3, quads 4-7
    # are zero, quads 8 and 9 take 4 rows each from their own first rows
    bands = tfg.quad_bands(g, 4)
    assert bands == [(0, 4)] * 4 + [(0, 0)] * 4 + [(4, 8), (12, 16)]
    band, ranges = tfg.band_layout(g, bands, 1)
    assert ranges.tolist() == [[0, 4]] * 4 + [[0, 0]] * 4 + [[4, 4], [12, 4]]
    assert band.shape == (10, 4, 4)
    assert band[1, 2, 1] == 2.0 and band[8, 3, 1] == 1.0 and band[9, 0, 3].isnan()
    assert band[4:8].abs().sum() == 0 and band[0].abs().sum() == 0
    # a group's deepest band runs to the window's end: the others move up
    g = torch.zeros((21, 8))
    g[0:6, 0] = 1.0
    g[14:21, 4:8] = 1.0
    assert tfg.quad_bands(g, 2) == [(0, 12), (12, 24)]


@pytest.mark.parametrize("in_rate,out_rate,denominator", LONG_HOP_PAIRS)
def test_slot_form_fits_on_long_hops(in_rate, out_rate, denominator):
    """On a 60 s channel at 132 SMs the six long-hop pairs and the exact
    ratio take the slot form, whose CTAs fit ``per_sm`` to an SM by shared
    memory (``SMEM_LIMIT`` a CTA), threads and registers, keep at least
    ``SLOT_WARPS_SM`` warps busy an SM (the exact ratio: every group of
    quads once), and each walk two frame blocks or more, so that a block's
    copy is in flight while the one before is summed."""
    window, m, hop, blocks, ranges, depth = pair_framing(in_rate, out_rate, 60.0, denominator)
    cut = tfg.tiling(window, m, hop, n_frames=blocks, sms=132, ranges=ranges, depth=depth)
    assert cut.slots and not cut.band and depth >= tfg.SLOT_DEPTH
    red = cut.threads * cut.fpt * 4 if cut.ksplit > 1 else 0
    smem = cut.span_bytes + 4 * red
    assert smem <= tfg.SMEM_LIMIT
    regs = -(-tfg.SLOT_REGISTERS[cut.fpt] // 8) * 8
    assert cut.per_sm == min(tfg.SMEM_SM // (smem + 1024), 2048 // cut.threads,
                             65536 // (regs * cut.threads))
    ctas = tfg.launch_ctas(cut, blocks, 132)
    assert ctas == cut.per_sm * 132 and -(-blocks // cut.frames) >= 2 * ctas
    warps = cut.per_sm * cut.threads // 32
    quads = -(-m // 4)
    assert warps >= tfg.SLOT_WARPS_SM or (cut.fpt == 1 and cut.threads // 32 == -(-quads // cut.cg))
    # (frames a lane, row split, CTAs an SM) as the rule gives them
    assert (cut.fpt, cut.ksplit, cut.per_sm) == {
        (192000.0, 11025.0, 1000): (2, 4, 1), (192000.0, 22050.0, 1000): (2, 2, 1),
        (176400.0, 16000.0, 1000): (4, 4, 1), (192000.0, 44100.0, 1000): (2, 1, 2),
        (96000.0, 22050.0, 1000): (2, 1, 2), (176400.0, 32000.0, 1000): (2, 1, 3),
        (192000.0, 11025.0, 10**6): (1, 1, 1)}[(in_rate, out_rate, denominator)]
