"""The fused kernel's three shared-memory layouts and its fp32 first layer
on the tensor cores, on the CPU.

  (a) ``smem_bytes`` equals a count of each region of each layout (resident,
      span, streamed) by hand, at two geometries: fft 1024 with overlap 900
      (the span layout's case) and the sample geometry with 128 hidden
      units (the first layer on the tensor cores);
  (b) the layouts are tried in order: the span layout wherever a CTA of
      128 frames or more fits it and the resident one does not fit, for
      every fuzz seed 1000-1299 and wide geometry, entry and frames choice;
  (c) the fp32 first layer on the tensor cores: its TF32 bank tiles hold
      the bank's TF32 halves where the kernel reads them, its three TF32
      products meet the float64 conv to fp32 accuracy, and the plain
      version (a float32 sum of T taps) meets the JAX fused
      function (its Pallas kernel in interpret mode) at hidden64 and
      hidden128 within the JAX kernel's tolerance: 1e-3/2e-4, and 2e-3/5e-4
      under dB scaling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.kernels import fused_detector as jfused
from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.kernels import fused_detector as tfused
from syllable_detector_tpu_torch.models import detector as tdet
from syllable_detector_tpu_torch.models.neural_net import params_from_numpy

torch.set_num_threads(1)

STEP = 8 * 64  # floats of one k-step of one 64-column chunk
STAGES = 3  # stages of C in the resident layout
STREAM_STAGES = 4  # in the streamed layout, each over a pass's chunks
A_STAGES = 3  # the streamed layout's k-blocks of A
SEEDS = range(1000, 1300)
# (tier, frames input) of the fused kernel's entries
ENTRIES = [(None, False), (None, True)] + [(tier, False) for tier in tfused.TIERS]


def spec_of(cfg):
    return tdet.detector_spec_from_config(cfg, "cpu")[0]


def wide(name):
    return spec_of(dict(fixtures.wide_geometry_configs())[name])


def test_smem_bytes_counts_each_region_at_fft1024_overlap900():
    """Window 1024, hop 124, 221 bins (7 chunks of C), timeRange 10, widths
    [4, 1], 128 frames (119 evaluations): the span fits, C's stages over
    every chunk and the spectrogram do not beside it."""
    spec = wide("fft1024 overlap900")
    assert (spec.window_length, spec.hop, spec.n_bins, spec.time_range) == (1024, 124, 221, 10)
    assert not tfused.tc_first_layer(spec)
    span = 127 * 124 + 1024  # 16772, whole 16-byte chunks already
    spectrogram = 128 * 221
    acts = 119 * 4  # one activation buffer, whole chunks already
    sums = 128 + 119 + 1  # row sums and norms, to whole chunks
    resident = span + STAGES * 2 * 2 * STEP * 7 + spectrogram + 128 + 2 * acts
    assert tfused.smem_bytes(spec, 128, 4) == 4 * resident
    # the span layout over 2 chunks a pass (a round's, each warpgroup taking
    # a 64-frame group and both chunks): span, C's stages, spectrogram,
    # act_a, sums
    span_layout = span + STAGES * 2 * 2 * STEP * 2 + spectrogram + acts + sums
    assert tfused.smem_bytes(spec, 128, 4, col_group=-2) == 4 * span_layout <= tfused.SMEM_LIMIT
    assert tfused.smem_bytes(spec, 128, 4, col_group=-3) > tfused.SMEM_LIMIT
    # streamed over 3: C's stages, three k-blocks of A [128, 16 + 4] and the
    # mu-law table, the spectrogram, sums
    a_blocks = A_STAGES * 128 * 20 + 256
    streamed = STREAM_STAGES * 2 * 2 * STEP * 3 + a_blocks + spectrogram + sums
    assert tfused.smem_bytes(spec, 128, 4, col_group=3) == 4 * streamed
    # a tier: A blocks of 32 rows; its first layer chunked outside the
    # resident layout, its product [128, 72] over the span (which is larger)
    # or after two bank steps in the streamed ring (which is larger still)
    assert tfused.smem_bytes(spec, 128, 4, "split", col_group=-2) == 4 * span_layout
    assert tfused.smem_bytes(spec, 128, 4, "split", col_group=3) == 4 * (
        STREAM_STAGES * 2 * 2 * STEP * 3 + A_STAGES * 128 * 36 + 256 + spectrogram + sums)
    # frames input: the rows at a stride of 1024 + 4 take the span's place
    rows = 128 * 1028
    assert tfused.smem_bytes(spec, 128, 4, None, True, -1) == 4 * (
        rows + STAGES * 2 * 2 * STEP + spectrogram + acts + sums)
    assert tfused.round_chunks(spec, 128) == 2 and tfused.round_chunks(spec, 64) == 4
    assert tfused.cta_choice(spec, 20000, 1, 4) == (128, -2)
    assert tfused.cta_choice(spec, 20000, 1, 4).layout == "span"


def test_smem_bytes_counts_each_region_at_hidden128():
    """The sample geometry (window 256, hop 132, 29 bins, one chunk of C,
    timeRange 10) with 128 hidden units, 128 frames: the fp32 first layer
    on the tensor cores takes a bank ring and one chunk of its product."""
    spec = wide("hidden128")
    assert tfused.tc_first_layer(spec) and spec.net.layer_sizes[0][1] == 128
    span = 127 * 132 + 256  # 17020
    product = 128 * 72  # one 64-column chunk of the conv product, rows of 72
    spectrogram = 128 * 29
    acts = 119 * 128
    sums = 128 + 119 + 1
    c_stages = STAGES * 2 * 2 * STEP
    c_ring = STREAM_STAGES * 2 * 2 * STEP
    # resident: the product over the span, the bank ring in C's stages
    assert tfused.smem_bytes(spec, 128, 128) == 4 * (
        max(span, product) + c_stages + spectrogram + 128 + 2 * acts)
    # span layout: rows region (span, product, second activation buffer)
    assert tfused.smem_bytes(spec, 128, 128, col_group=-1) == 4 * (
        max(span, product, acts) + c_stages + spectrogram + acts + sums)
    # streamed: the ring holds two bank steps (both halves) and the product
    ring = max(c_ring, 2 * 2 * STEP + product)
    streamed = ring + max(acts, A_STAGES * 128 * 20 + 256) + max(spectrogram, acts) + sums
    assert tfused.smem_bytes(spec, 128, 128, col_group=1) == 4 * streamed
    # on the CUDA cores the streamed ring is C's stages alone
    assert tfused.smem_bytes(spec, 128, 128, col_group=1, tc=False) == 4 * (
        streamed - ring + c_ring)
    assert tfused.cta_choice(spec, 20000, 1, 128) == (128, 0)


@pytest.fixture(scope="module")
def geometries():
    out = []
    for seed in SEEDS:
        spec = spec_of(fixtures.random_config(np.random.default_rng(seed)))
        if tfused.fusable(spec):
            out.append((f"seed {seed}", spec))
    out += [(name, spec_of(cfg)) for name, cfg in fixtures.wide_geometry_configs()]
    return out


@pytest.mark.parametrize("tier,frames_input", ENTRIES)
def test_layouts_are_tried_in_order(geometries, tier, frames_input):
    """For each frames choice: resident where any choice fits there; else
    the span layout where this choice is 128 frames or more and fits
    there, a round's chunks a pass (two at 128 frames) or fewer where they
    do not fit; else the streamed one (four chunks at 64 frames). The span
    layout is taken at the fft 1024 net in fp32 from samples, not at 96 kHz
    fft 1024, where it fits only at 64 frames."""
    taken = {}
    for name, spec in geometries:
        width = max(w for _, w in spec.net.layer_sizes)
        choices = [f for f in tfused.CTA_FRAMES if f > spec.time_range - 1] or [
            -(-spec.time_range // 64) * 64]

        def fits(f, group):
            return tfused.smem_bytes(spec, f, width, tier, frames_input, group) <= tfused.SMEM_LIMIT

        resident = any(fits(f, 0) for f in choices)
        for f in choices:
            group = tfused.col_group_for(spec, f, width, tier, frames_input)
            if resident:
                want = 0 if fits(f, 0) else None
            else:
                signs = (-1, 1) if f >= 128 else (1,)
                want = next((sign * g for sign in signs
                             for g in range(tfused.round_chunks(spec, f), 0, -1)
                             if fits(f, sign * g)), None)
            assert group == want, (name, f)
        taken[name] = tfused.cta_choice(spec, 20000, 1, width, tier=tier,
                                        frames_input=frames_input).layout
    if tier is None and not frames_input:
        assert taken["fft1024 overlap900"] == "span" and taken["96k fft1024"] == "streamed"
        assert taken["fuzz1066"] == "streamed" and taken["hidden128"] == "resident"
    assert set(taken.values()) >= {"resident", "streamed"}


def test_tf32_bank_tiles_hold_the_banks_halves():
    """Element (bin k, column t*h1 + j) of half h of the bank lies at [h,
    k // 8, c // 64, (c % 64) // 8, (k % 8) // 4, c % 8, k % 4], as one
    k-step of C's tiles holds its rows and columns."""
    rng = np.random.default_rng(3)
    w1 = torch.from_numpy(rng.standard_normal((3, 21, 40)).astype(np.float32))
    tiled = tfused.tile_conv_bank_tf32(w1)
    assert tuple(tiled.shape) == (2, 3, 2, 8, 2, 8, 4)
    bank = w1.transpose(0, 1).reshape(21, 120)
    hi = tfused._tf32(bank)
    lo = tfused._tf32(bank - hi)
    k, c = torch.meshgrid(torch.arange(24), torch.arange(128), indexing="ij")
    for h, half in enumerate((hi, lo)):
        got = tiled[h, k // 8, c // 64, (c % 64) // 8, (k % 8) // 4, c % 8, k % 4]
        want = torch.zeros(24, 128)
        want[:21, :120] = half
        assert torch.equal(got, want)


def test_tf32_split_bank_is_fp32_accurate():
    """The kernel's fp32 first layer on the tensor cores is three TF32
    products of the split spectrogram and bank, ``m_lo @ w_hi + m_hi @ w_lo
    + m_hi @ w_hi``, then the T shifted sums: about 1e-6 relative to the
    float64 conv on seeded magnitudes, which is why the plain version keeps
    its float32 sum of T taps."""
    rng = np.random.default_rng(4)
    mag = rng.uniform(0.0, 3.0, (2, 40, 29))
    w1 = rng.standard_normal((10, 29, 64)) * 0.1
    m_hi, m_lo = tfused._tf32_hi_lo(torch.from_numpy(mag.astype(np.float32)))
    bank = tfused._conv_bank(torch.from_numpy(w1.astype(np.float32)))
    w_hi, w_lo = tfused._tf32_hi_lo(bank)
    conv = m_lo @ w_hi + m_hi @ w_lo + m_hi @ w_hi
    got = sum(conv[:, t : t + 31, t * 64 : (t + 1) * 64] for t in range(10))
    want = sum(mag[:, t : t + 31] @ w1[t] for t in range(10))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden,scaling", [(64, "linear"), (128, "linear"), (64, "db")])
def test_tensor_core_first_layer_plain_version_matches_jax(hidden, scaling):
    cfg = fixtures.geometry_config(11, hidden=(hidden,), scaling=scaling)
    jspec, jparams = jdet.detector_spec_from_config(cfg)
    tspec, _ = tdet.detector_spec_from_config(cfg, "cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert tfused.tc_first_layer(tspec)
    x = fixtures.chirp_audio(0.4, 12)
    got = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x)).numpy()
    want = np.asarray(jfused.fused_offline_outputs(jspec, jparams, jnp.asarray(x),
                                                   interpret=True, tile=64))
    rtol, atol = (2e-3, 5e-4) if scaling != "linear" else (1e-3, 2e-4)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
