"""The port of the JAX package's fuzz test (``tests/test_fuzz.py``): random
detector geometries, drawn by the same generator, through the port's paths
against the JAX functions, and through the admission of the port's fused
kernel and framed GEMM kernel.

  (a) ``fixtures.random_config`` draws the JAX generator's configs;
  (b) the fused kernel admits, in shared memory, every generator seed
      1000-1299 and every geometry of ``fixtures.wide_geometry_configs`` on
      each of its entries (fp32 from samples, from frames, each tier) for
      one lane and for 256 (per-lane nets add no shared memory: their
      operands are read where they lie), the corners of its envelope too,
      and a geometry outside the envelope raises naming it;
  (c) seeds 1000-1011, as the JAX test draws them, through the port's
      paths against the JAX functions on the same inputs;
  (d) the framed GEMM's tiling fits every rate pair of
      ``fixtures.RESAMPLE_RATES``.

Tolerance of (c): rtol=1e-3, atol=1e-4, NaN in the same places. The JAX
fuzz test holds the JAX paths to a NumPy oracle at 5e-3/1e-3; the port and
the JAX package compute the same float32 algebra and are held closer.
"""

import importlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.config.model_format import dumps_config as jax_dumps_config
from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.config.model_format import dumps_config
from syllable_detector_tpu_torch.kernels import fused_detector as tfused
from syllable_detector_tpu_torch.models import detector as tdet
from syllable_detector_tpu_torch.models.detector_bank import DetectorBank
from syllable_detector_tpu_torch.models.neural_net import params_from_numpy
from syllable_detector_tpu_torch.ops.resample import polyphase_plan
from syllable_detector_tpu_torch.ops.stft import hop_length
from syllable_detector_tpu_torch.parallel import mesh as tmesh
from test_fuzz import random_config as jax_random_config

# the kernels package exports the function framed_gemm under its module's
# name, as the JAX package does, so the module comes from the import system
tfg = importlib.import_module("syllable_detector_tpu_torch.kernels.framed_gemm")

torch.set_num_threads(1)

SEEDS = range(1000, 1300)
BLOCK = 30
RTOL, ATOL = 1e-3, 1e-4
# (entry, tier, frames input) of the fused kernel
ENTRIES = [("fp32", None, False), ("frames", None, True)] + [
    (tier, tier, False) for tier in tfused.TIERS
]


def close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("block", range(len(SEEDS) // BLOCK))
def test_random_config_draws_the_jax_generators_configs(block):
    for seed in SEEDS[block * BLOCK : (block + 1) * BLOCK]:
        got = dumps_config(fixtures.random_config(np.random.default_rng(seed)))
        want = jax_dumps_config(jax_random_config(np.random.default_rng(seed)))
        assert got == want, seed


@pytest.fixture(scope="module")
def geometries():
    """(name, port spec) of every fusable generator seed and wide geometry."""
    out = []
    for seed in SEEDS:
        spec = tdet.detector_spec_from_config(
            fixtures.random_config(np.random.default_rng(seed)), "cpu")[0]
        if tfused.fusable(spec):
            out.append((f"seed {seed}", spec))
    for name, cfg in fixtures.wide_geometry_configs():
        spec = tdet.detector_spec_from_config(cfg, "cpu")[0]
        assert tfused.fusable(spec), name
        out.append((name, spec))
    return out


def admitted(spec, n_evals, lanes, tier, frames_input):
    """The kernel's choice for a launch, checked: whole wgmma tiles, the
    resident layout wherever it fits, else the span layout wherever the
    chosen CTA has 128 frames or more and fits it, shared memory within the
    card's."""
    width = max(w for _, w in spec.net.layer_sizes)
    choice = tfused.cta_choice(spec, n_evals, lanes, width, tier=tier,
                               frames_input=frames_input)
    assert choice.frames % 64 == 0 and choice.frames > spec.time_range - 1
    assert abs(choice.col_group) <= tfused._dft_chunks(spec)
    smem = tfused.smem_bytes(spec, choice.frames, width, tier, frames_input, choice.col_group)
    assert smem <= tfused.SMEM_LIMIT
    resident_fits = any(
        tfused.smem_bytes(spec, f, width, tier, frames_input) <= tfused.SMEM_LIMIT
        for f in tfused.CTA_FRAMES if f > spec.time_range - 1
    )
    assert (choice.col_group == 0) == resident_fits
    # the span layout for CTAs of 128 frames or more
    span_fits = tfused.smem_bytes(
        spec, choice.frames, width, tier, frames_input, -1) <= tfused.SMEM_LIMIT
    assert (choice.col_group < 0) == (span_fits and choice.frames >= 128 and not resident_fits)
    return choice


@pytest.mark.parametrize("lanes", [1, 256])
@pytest.mark.parametrize("entry,tier,frames_input", ENTRIES)
def test_fused_kernel_admits_every_fuzz_and_wide_geometry(
    geometries, entry, tier, frames_input, lanes
):
    streamed = []
    for name, spec in geometries:
        layouts = {admitted(spec, n_evals, lanes, tier, frames_input).layout
                   for n_evals in (1, 128, 20000)}
        if layouts != {"resident"}:
            streamed.append(name)
    # the resident layout does not hold 29 of the generator's seeds in fp32
    # and under the fast tier (fewer from frames), all at fft 512; each wide
    # geometry is so named because some entry does not fit it
    seeds = [n for n in streamed if n.startswith("seed")]
    assert seeds and all(spec.fourier_length == 512
                         for name, spec in geometries if name in seeds)
    if entry in ("fp32", "fast"):
        assert len(seeds) == 29 and "seed 1022" in seeds and "seed 1066" in seeds
        assert "fft1024 overlap900" in streamed and "96k fft1024" in streamed
    if entry == "fast":
        assert "hidden64" in streamed and "hidden128" in streamed


@pytest.mark.parametrize("time_range", [1, 32])
@pytest.mark.parametrize("hidden", [(1,), (256,), (256, 256, 8)])
def test_envelope_corners_fit(time_range, hidden):
    """fft 1024 over the whole band (512 bins), the widest layers and the
    timeRange range of the envelope, with a gap: every entry fits."""
    cfg = fixtures.geometry_config(fft=1024, overlap=-300, freq=(0.0, 22050.0),
                                   time_range=time_range, hidden=hidden)
    spec = tdet.detector_spec_from_config(cfg, "cpu")[0]
    assert spec.n_bins >= 512
    for _, tier, frames_input in ENTRIES:
        for lanes in (1, 256):
            choice = admitted(spec, 5000, lanes, tier, frames_input)
            assert choice.col_group  # the resident layout cannot hold 512 bins


def test_outside_the_envelope_raises_naming_it():
    wide = tdet.detector_spec_from_config(
        fixtures.geometry_config(fft=4096, freq=(0.0, 22050.0)), "cpu")[0]
    with pytest.raises(ValueError, match="shared memory") as err:
        tfused.cta_choice(wide, 1000, 1, 4)
    assert tfused.ENVELOPE in str(err.value) and "fft <= 1024" in tfused.ENVELOPE
    # the shared-memory mirror of the streamed layout, at the envelope's
    # widest corner: 64 frames, one chunk of C a pass, 512 bins, h1 = 256
    spec = tdet.detector_spec_from_config(
        fixtures.geometry_config(fft=1024, freq=(0.0, 22050.0), time_range=1,
                                 hidden=(256,)), "cpu")[0]
    b = spec.n_bins
    ring = 4 * 2 * 2 * 512  # four stages of C, one chunk each
    acts = 64 * 256
    # T*h1 = 256: the fp32 first layer's bank ring and product where it runs
    # on the tensor cores
    fp32_ring = max(ring, 2 * 1024 + 64 * 72) if tfused.tc_first_layer(spec) else ring
    assert tfused.smem_bytes(spec, 64, 256, None, False, 1) == 4 * (
        fp32_ring + acts + 64 * b + 128)
    # a bf16 first layer's two bank steps and product, and a tier's three A
    # blocks of 32 rows
    assert tfused.smem_bytes(spec, 128, 256, "split", False, 1) == 4 * (
        max(ring, 2 * 1024 + 128 * 72) + 128 * 256 + 128 * b + 256)
    assert tfused.smem_bytes(spec, 64, 4, "split", False, 1) == 4 * (
        max(ring, 2 * 1024 + 64 * 72) + max(64 * 4, 3 * 64 * 36 + 256) + 64 * b + 128)


def perturbed(params, seed):
    """The JAX test's per-lane net: every leaf times 1 + 0.05 N(0, 1)."""
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) * (1.0 + 0.05 * r.standard_normal(np.asarray(a).shape)),
        params,
    )


def fed_in_chunks(feed, drain, x, rng, low, high):
    """``x`` appended in chunks of ``rng.integers(low, high)`` samples, the
    outputs of a drain after each, concatenated."""
    outs, pos = [], 0
    while pos < len(x):
        c = int(rng.integers(low, high))
        feed(x[pos : pos + c])
        o = drain()
        if len(o):
            outs.append(o)
        pos += c
    return np.concatenate(outs) if outs else None


@pytest.mark.parametrize("seed", range(12))
def test_random_geometry_paths_match_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = jax_random_config(rng)
    jspec, jparams = jdet.detector_spec_from_config(cfg)
    tspec, tparams = tdet.detector_spec_from_config(
        fixtures.random_config(np.random.default_rng(1000 + seed)), "cpu")
    n = int(rng.integers(4 * (cfg.gap + cfg.window_length), 30000))
    x = (rng.standard_normal(n) * 0.3 + 0.05).astype(np.float32)
    x += 0.05 * np.sin(2 * np.pi * 0.1 * np.arange(n)).astype(np.float32)
    xt = torch.from_numpy(x)
    want = np.asarray(jdet.offline_outputs(jspec, jparams, jnp.asarray(x)))
    close(tdet.offline_outputs(tspec, tparams, xt), want, "offline_outputs")

    det = tdet.Detector(fixtures.random_config(np.random.default_rng(1000 + seed)),
                        device="cpu")
    stream = fed_in_chunks(det.append_audio_data, det.drain, x, rng, 50, 5000)
    if len(want):
        close(stream, want, "streaming Detector")

    mesh_t = tmesh.make_mesh(4, axis="time", devices=["cpu"])
    close(tmesh.time_sharded_offline_outputs(mesh_t, tspec, tparams, xt), want, "time-sharded")
    if not tfused.fusable(tspec) or not len(want):
        return
    close(tfused.fused_offline_outputs(tspec, tparams, xt), want, "fused plain version")
    close(tfused.fused_offline_outputs(tspec, tparams, xt, input_mode="frames"), want,
          "fused plain version, frames input")
    mesh_m = tmesh.make_mesh(4, axis="model", devices=["cpu"])
    close(tmesh.tensor_sharded_offline_outputs(mesh_m, tspec, tparams, xt), want,
          "tensor-sharded")

    # per-lane nets on the batched (grid) and flat forms, against the JAX
    # function on each lane's net
    jlist = [jparams, perturbed(jparams, seed), perturbed(jparams, seed + 99)]
    tlist = [params_from_numpy(jax.tree.map(np.asarray, p), "cpu") for p in jlist]
    xs = torch.from_numpy(np.stack([x, np.roll(x, 97), np.roll(x, 211)]))
    wants = np.stack([
        np.asarray(jdet.offline_outputs(jspec, jax.tree.map(jnp.asarray, p), jnp.asarray(xx)))
        for p, xx in zip(jlist, xs.numpy())
    ])
    close(tfused.fused_batch_offline_outputs(tspec, tlist, xs, layout="grid"), wants, "grid")
    close(tfused.fused_flat_batch_offline_outputs(tspec, tlist, xs), wants, "flat per-lane")

    # the bank against the port's Detector fed the same chunks
    pcfg = fixtures.random_config(np.random.default_rng(1000 + seed))
    bank = DetectorBank([pcfg, pcfg], device="cpu")
    lone = tdet.Detector(pcfg, device="cpu")
    got, ref = [], []
    pos = 0
    while pos < n:
        c = int(rng.integers(400, 6000))
        for lane in (0, 1):
            bank.append_audio_data(lane, x[pos : pos + c])
        lone.append_audio_data(x[pos : pos + c])
        bo, do = bank.drain(), lone.drain()
        if bo.shape[1]:
            got.append(bo[0])
        if len(do):
            ref.append(do)
        pos += c
    got = np.concatenate(got) if got else np.zeros((0, want.shape[1]), np.float32)
    ref = np.concatenate(ref) if ref else np.zeros((0, want.shape[1]), np.float32)
    close(got, ref, "DetectorBank vs Detector")


def test_tune_takes_a_wide_geometry(tmp_path, monkeypatch, capsys):
    """``tune`` times every candidate in the layout the kernel takes there
    (it found none that fit before the streamed layout): 64 frames
    streamed, 128 in the span layout, and reports the rule's choice, which
    the launch takes outside the resident layout."""
    from syllable_detector_tpu_torch import tuning
    from syllable_detector_tpu_torch.config.model_format import save_config

    cfg = dict(fixtures.wide_geometry_configs())["fft1024 overlap900"]
    net = tmp_path / "wide.txt"
    save_config(cfg, str(net))
    timed = []

    def fake_measure(spec, params, workload, lanes, n_evals, frames, device):
        timed.append((frames, tfused.col_group_for(spec, frames, width)))
        return {64: 0.2, 128: 0.3}[frames]

    spec = tdet.detector_spec_from_config(cfg, "cpu")[0]
    width = max(w for _, w in spec.net.layer_sizes)
    monkeypatch.setattr(tuning, "_measure", fake_measure)
    assert tuning.main(["-n", str(net), "--workload", "single", "--device", "cpu"]) == 0
    assert [f for f, _ in timed] == [64, 128] and all(group for _, group in timed)
    assert timed[0][1] > 0  # 64 frames: the streamed layout
    choice = tfused.cta_choice(spec, tuning.SINGLE_EVALS, 1, width)
    assert choice == (128, tfused.col_group_for(spec, 128, width)) and choice.col_group
    out = capsys.readouterr().out
    assert out.startswith("single: frames 64 0.2000 ms ") and "; rule 128; " in out


def rate_pairs():
    return [(a, b) for a in fixtures.RESAMPLE_RATES for b in fixtures.RESAMPLE_RATES if a != b]


@pytest.mark.parametrize("max_denominator", [1000, 10**6])
def test_framed_gemm_tiling_fits_every_rate_pair(max_denominator):
    """The resampler's ratio (the default ``max_denominator``) and the exact
    one: every pair's framed GEMM fits, the exact 192k -> 11.025k (window
    2891, hop 2560) with 4 frames a thread."""
    narrow = []
    for in_rate, out_rate in rate_pairs():
        frac = Fraction(out_rate / in_rate).limit_denominator(max_denominator)
        g, _, w_len, overlap = polyphase_plan(frac.numerator, frac.denominator)
        hop = hop_length(w_len, overlap)
        cut = tfg.tiling(w_len, g.shape[1], hop)
        if cut.slots:  # two blocks of one unit of frames, a slot of `stride` floats each
            assert cut.frames == cut.fpt * 32 // cut.cg
            assert cut.span_bytes == 2 * 4 * cut.frames * cut.stride <= tfg.SMEM_LIMIT
        # the run form takes every pair too
        cut = tfg._run_tiling(w_len, g.shape[1], hop)
        unit = cut.fpt * 32 // cut.cg
        assert cut.frames % unit == 0 and cut.span_bytes <= tfg.SMEM_LIMIT
        assert cut.span_bytes == 4 * (-(-((cut.frames - 1) * hop + w_len + 8) // 4) * 4)
        if cut.fpt != tfg.FRAMES_PER_THREAD:
            narrow.append((in_rate, out_rate))
    assert narrow == ([] if max_denominator == 1000 else [(192000, 11025)])
    cut = tfg._run_tiling(2891, 147, 2560)
    assert (cut.fpt, cut.frames, cut.cg, cut.n_tiles) == (tfg.NARROW_FRAMES, 16, 8, 5)
    assert cut.span_bytes == 4 * 41300  # (15 * 2560 + 2891 + 8) floats, in 16-byte chunks
    # the slot form at the exact ratio: one frame a lane, 8 frames a block
    cut = tfg.tiling(2891, 147, 2560)
    assert cut.slots and (cut.fpt, cut.frames, cut.stride) == (1, 8, 2892)


@pytest.mark.cuda
def test_streamed_layout_equals_resident_on_card():
    """On the card, every layout the kernel can take at the sample geometry
    gives the resident layout's outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = fixtures.sample_geometry_config(0)
    spec, params = tdet.detector_spec_from_config(cfg, "cuda")
    folded = tfused.fold_constants(spec, params, "cuda")
    x = torch.from_numpy(fixtures.chirp_audio(2.0, 5)).cuda()
    for tier in (None, *tfused.TIERS):
        kw = fixtures.TIER_CASES[tier][0] if tier else {}
        want = tfused.fused_offline_outputs(spec, params, x, folded=folded, **kw)
        for frames, group in ((128, 1), (64, 1)):
            got = tfused._launch(spec, folded, x[None], want.shape[0], tier=tier,
                                 frames=frames, col_group=group)[0]
            np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
