"""The port's precision tiers (bf16 hi/lo products), frames input and
slabbed grid layout against the JAX package's Pallas kernel, run in
interpret mode on the CPU.

On the CPU the port runs each kernel's plain version. Tolerances, plain
version against the JAX kernel with the same tier: rtol=2e-3, atol=5e-4 for
``split=True`` and ``split="conv"`` (tests/test_kernels.py's bound for the
split tiers), rtol=1e-2, atol=1e-2 for ``split=4`` (the JAX package's own
test of it) and for ``fast`` (one bf16 pass keeps about three digits; in
interpret mode the JAX kernel's DEFAULT precision is a float32 product, so
this compares one bf16 pass with fp32; log scaling amplifies the rounding
of small magnitudes, and ``fast`` is held to 5e-2 there).
Frames input and the fp32 grid layout: rtol=1e-4, atol=1e-5, the port's
contract for its fp32 paths against the JAX functions. NaN (digital silence
under l2normalize) must fall in the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.kernels import fused_detector as jfused
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.kernels import fused_detector as tfused
from syllable_detector_tpu_torch.models import detector as tdet
from test_torch_fused_detector import both

torch.set_num_threads(1)

TIER_KW = fixtures.TIER_CASES  # tier -> (the JAX functions' keywords, rtol, atol)
CASES = {case[0]: case for case in fixtures.fused_cases(seconds=0.5)}


def close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def lanes_audio(lanes: int, seconds: float = 0.25) -> np.ndarray:
    return np.stack([fixtures.chirp_audio(seconds, 70 + i) for i in range(lanes)])


def stacked(lanes: int):
    """(port spec, per-lane port params, JAX spec, per-lane JAX params) for
    ``lanes`` nets of one geometry with their own seeded weights."""
    quads = [both(fixtures.sample_geometry_config(80 + i)) for i in range(lanes)]
    return quads[0][0], [q[1] for q in quads], quads[0][2], [q[3] for q in quads]


def test_tiers_table_matches_jax_arguments():
    assert set(tfused.TIERS) == set(TIER_KW) == set(tfused.TIER_LAUNCHES)
    assert tfused._tier_of(False, None) is None and tfused._tier_of(False, False) is None
    for tier, (kw, _, _) in TIER_KW.items():
        assert tfused._tier_of(kw.get("fast", False), kw.get("split")) == tier
    assert tfused._tier_of(True, 4) == "fast"  # fast wins, as in the JAX kernel
    with pytest.raises(ValueError, match="unknown split"):
        tfused._tier_of(False, 2)
    with pytest.raises(ValueError, match="unknown tier"):
        spec, params = tdet.detector_spec_from_config(CASES["linear"][1], "cpu")
        tfused.fused_tier_outputs_reference(
            spec, tfused.fold_constants(spec, params, "cpu"), torch.zeros(1, 5000), "tf32"
        )


@pytest.mark.parametrize("name", ["linear", "deep"])
def test_split_operands_are_the_jax_halves(name):
    """The bf16 halves the kernel reads: hi + lo of C and of the conv filter
    bank equal the JAX kernel's ``hi_lo`` of its own operands, and the
    padding to the tensor-core fragment is zero in both."""
    tspec, tparams, jspec, jparams = both(CASES[name][1])
    folded = tfused.fold_constants(tspec, tparams, "cpu")
    c_hi, c_lo, w_hi, w_lo = folded.tiers
    ops, meta = jfused.fold_constants(jspec, jparams, pack=False)
    window, b, t_range = tspec.window_length, tspec.n_bins, tspec.time_range
    h1 = folded.c1.shape[0]
    assert c_hi.dtype == c_lo.dtype == w_hi.dtype == torch.bfloat16
    assert c_hi.shape == (256, 64) and w_hi.shape == (32, -(-t_range * h1 // 16) * 16)

    def jax_halves(a):
        hi = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
        lo = (jnp.asarray(a) - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        return np.asarray(hi.astype(jnp.float32)), np.asarray(lo.astype(jnp.float32))

    want_hi, want_lo = jax_halves(np.concatenate(
        [ops[0][:, :b], ops[0][:, meta.b_pad : meta.b_pad + b]], axis=1))
    np.testing.assert_array_equal(c_hi[:window, : 2 * b].float().numpy(), want_hi)
    np.testing.assert_array_equal(c_lo[:window, : 2 * b].float().numpy(), want_lo)
    w_want_hi, w_want_lo = jax_halves(ops[1])
    for t in range(t_range):
        cols = slice(t * h1, (t + 1) * h1)
        jcols = slice(t * meta.hs, t * meta.hs + h1)
        np.testing.assert_array_equal(w_hi[:b, cols].float().numpy(), w_want_hi[:b, jcols])
        np.testing.assert_array_equal(w_lo[:b, cols].float().numpy(), w_want_lo[:b, jcols])
    for half in (c_hi, c_lo):
        assert not half[:, 2 * b :].float().any() and not half[window:].float().any()
    for half in (w_hi, w_lo):
        assert not half[b:].float().any() and not half[:, t_range * h1 :].float().any()
    # per-lane nets: one filter bank per lane, the DFT matrix shared
    stack = tfused.fold_constants_stacked(tspec, [tparams, tparams], "cpu")
    assert stack.tiers[0].shape == c_hi.shape and stack.tiers[2].shape == (2, *w_hi.shape)
    np.testing.assert_array_equal(stack.tiers[3][1].float().numpy(), w_lo.float().numpy())


@pytest.mark.parametrize("tier", list(TIER_KW))
@pytest.mark.parametrize("name", ["linear", "log", "gap", "deep"])
def test_tier_plain_version_matches_jax(name, tier):
    _, cfg, x, _, _ = CASES[name]
    kw, rtol, atol = TIER_KW[tier]
    if tier == "fast" and name == "log":
        rtol = atol = 5e-2
    tspec, tparams, jspec, jparams = both(cfg)
    counts = dict(tfused.TIER_LAUNCHES)
    got = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x), **kw).numpy()
    assert tfused.TIER_LAUNCHES == counts  # a CPU tensor never launches
    want = jfused.fused_offline_outputs(
        jspec, jparams, jnp.asarray(x), interpret=True, tile=64, **kw
    )
    close(got, want, rtol, atol)
    folded = tfused.fold_constants(tspec, tparams, "cpu")
    ref = tfused.fused_tier_outputs_reference(tspec, folded, torch.from_numpy(x)[None], tier)
    np.testing.assert_array_equal(ref[0].numpy(), got)
    fp32 = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x)).numpy()
    finite = np.isfinite(fp32)
    close(got[finite], fp32[finite], rtol, atol)
    if tier == "fast":  # one bf16 pass does change the values
        assert np.abs(got[finite] - fp32[finite]).max() > 1e-6


@pytest.mark.parametrize("nets", ["shared", "distinct"])
@pytest.mark.parametrize("tier", list(TIER_KW))
def test_tier_grid_matches_jax(tier, nets):
    kw, rtol, atol = TIER_KW[tier]
    lanes = 5
    tspec, tparams, jspec, jparams = stacked(lanes)
    if nets == "shared":
        tparams, jparams = tparams[0], jparams[0]
    xs = lanes_audio(lanes)
    got = tfused.fused_batch_offline_outputs(
        tspec, tparams, torch.from_numpy(xs), slab_channels=2, **kw
    ).numpy()
    want = jfused.fused_batch_offline_outputs(
        jspec, jparams, jnp.asarray(xs), interpret=True, tile=64,
        layout="grid", slab_channels=2, **kw,
    )
    close(got, want, rtol, atol)


@pytest.mark.parametrize("nets", ["shared", "distinct"])
@pytest.mark.parametrize("slab", [2, 64, None])
def test_grid_layout_matches_jax(slab, nets):
    lanes = 5
    tspec, tparams, jspec, jparams = stacked(lanes)
    if nets == "shared":
        tparams, jparams = tparams[0], jparams[0]
    xs = lanes_audio(lanes)
    count = tfused.GRID_LAUNCHES
    got = tfused.fused_batch_offline_outputs(
        tspec, tparams, torch.from_numpy(xs), layout="grid", slab_channels=slab
    ).numpy()
    assert tfused.GRID_LAUNCHES == count
    want = jfused.fused_batch_offline_outputs(
        jspec, jparams, jnp.asarray(xs), interpret=True, tile=64,
        layout="grid", slab_channels=slab,
    )
    close(got, want, 1e-4, 1e-5)
    flat = tfused.fused_batch_offline_outputs(tspec, tparams, torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, flat)
    short = tfused.fused_batch_offline_outputs(
        tspec, tparams, torch.from_numpy(xs), layout="grid", slab_channels=slab, n_evals=7
    ).numpy()
    np.testing.assert_array_equal(short, got[:, :7])
    with pytest.raises(ValueError, match="needs more than"):
        tfused.fused_batch_offline_outputs(
            tspec, tparams, torch.from_numpy(xs), layout="grid", n_evals=10**6
        )


@pytest.mark.parametrize("name", ["linear", "db", "short", "gap", "deep"])
def test_frames_input_matches_jax(name):
    _, cfg, x, _, _ = CASES[name]
    tspec, tparams, jspec, jparams = both(cfg)
    count = tfused.FRAMES_LAUNCHES
    got = tfused.fused_offline_outputs(
        tspec, tparams, torch.from_numpy(x), input_mode="frames"
    ).numpy()
    assert tfused.FRAMES_LAUNCHES == count
    want = jfused.fused_offline_outputs(
        jspec, jparams, jnp.asarray(x), interpret=True, tile=64, input_mode="frames"
    )
    close(got, want, 1e-4, 1e-5)
    # raw input gives the same values (tests/test_kernels.py's bound)
    raw = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x)).numpy()
    close(got, raw, 1e-5, 1e-6)


def test_frames_reference_and_modes():
    _, cfg, x, _, _ = CASES["linear"]
    tspec, tparams, jspec, jparams = both(cfg)
    folded = tfused.fold_constants(tspec, tparams, "cpu")
    xt = torch.from_numpy(x)
    f = tdet.num_frames(len(x), tspec.window_length, tspec.window_overlap)
    frames = tdet.frame_signal(xt, f, tspec.window_length, tspec.window_overlap)
    got = tfused.fused_frames_outputs_reference(tspec, folded, frames)
    np.testing.assert_array_equal(
        got.numpy(), tfused.fused_offline_outputs(tspec, tparams, xt, input_mode="frames").numpy()
    )
    assert tfused.fused_frames_outputs_reference(tspec, folded, frames[:5]).shape == (0, 1)
    # frames input under a tier, as the JAX function allows
    tiered = tfused.fused_offline_outputs(tspec, tparams, xt, input_mode="frames", split=True)
    want = jfused.fused_offline_outputs(
        jspec, jparams, jnp.asarray(x), interpret=True, tile=64, input_mode="frames", split=True
    )
    close(tiered.numpy(), want, 2e-3, 5e-4)
    with pytest.raises(ValueError, match="unknown input_mode"):
        tfused.fused_offline_outputs(tspec, tparams, xt, input_mode="slab")
    with pytest.raises(ValueError, match=r"shape \[n\]"):
        tfused.fused_offline_outputs(tspec, tparams, xt[None])
    # packed is the TPU's lane layout: accepted, changes nothing
    np.testing.assert_array_equal(
        tfused.fused_offline_outputs(tspec, tparams, xt, packed=True).numpy(),
        tfused.fused_offline_outputs(tspec, tparams, xt).numpy(),
    )


def test_tier_tile_fills_whole_fragments():
    for cfg in (CASES["linear"][1], CASES["gap"][1]):
        spec, _ = tdet.detector_spec_from_config(cfg, "cpu")
        for n_evals in (1, 8, 9, 31, 500, 20000):
            tile = tfused._tiers_tile(spec, n_evals)
            assert (tile + spec.time_range - 1) % 16 == 0
            assert tfused._tile(n_evals) <= tile < tfused._tile(n_evals) + 16
    spec, _ = tdet.detector_spec_from_config(CASES["linear"][1], "cpu")
    assert tfused._tiers_tile(spec, 20000) == 39


def test_cuda_tensors_never_fall_back():
    """Off the CPU every new entry goes for its kernel: a tensor on a
    device without one raises and runs no plain version."""
    spec, params = tdet.detector_spec_from_config(CASES["linear"][1], "cpu")
    folded = tfused.fold_constants(spec, params, "meta")
    x = torch.zeros(5000, device="meta")
    for kw in ({"split": True}, {"fast": True}, {"input_mode": "frames"}):
        with pytest.raises(ValueError, match="no fused detector kernel"):
            tfused.fused_offline_outputs(spec, params, x, folded=folded, **kw)
    for kw in ({"split": 4}, {"layout": "grid"}):
        with pytest.raises(ValueError, match="no fused detector kernel"):
            tfused.fused_batch_offline_outputs(spec, params, x[None], folded=folded, **kw)


@pytest.mark.cuda
def test_tier_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, cfg, x, _, _ in CASES.values():
        spec, params = tdet.detector_spec_from_config(cfg, "cuda")
        folded = tfused.fold_constants(spec, params, "cuda")
        xd = torch.from_numpy(x).cuda()
        for tier, (kw, rtol, atol) in TIER_KW.items():
            count = tfused.TIER_LAUNCHES[tier]
            got = tfused.fused_offline_outputs(spec, params, xd, folded=folded, **kw)
            torch.cuda.synchronize()
            assert tfused.TIER_LAUNCHES[tier] == count + 1
            want = tfused.fused_tier_outputs_reference(spec, folded, xd[None], tier)[0]
            close(got.cpu().numpy(), want.cpu().numpy(), rtol, atol)
        got = tfused.fused_offline_outputs(spec, params, xd, folded=folded, input_mode="frames")
        close(got.cpu().numpy(),
              tfused.fused_offline_outputs_reference(spec, folded, xd).cpu().numpy(), 1e-3, 2e-4)


@pytest.mark.cuda
def test_grid_slabs_match_flat_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    spec, params = tdet.detector_spec_from_config(CASES["linear"][1], "cuda")
    xs = torch.from_numpy(lanes_audio(5)).cuda()
    count = tfused.GRID_LAUNCHES
    got = tfused.fused_batch_offline_outputs(spec, params, xs, layout="grid", slab_channels=2)
    torch.cuda.synchronize()
    assert tfused.GRID_LAUNCHES == count + 3
    flat = tfused.fused_batch_offline_outputs(spec, params, xs)
    close(got.cpu().numpy(), flat.cpu().numpy(), 0, 1e-6)
