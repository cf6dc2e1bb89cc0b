"""The port's fused detector (folding, plain version, CUDA kernel) against
the JAX package's Pallas kernel, run in interpret mode on the CPU, and its
unfused path.

Tolerances are the JAX fused kernel's own against its unfused path
(tests/test_kernels.py): rtol=1e-3, atol=2e-4, and 2e-3/5e-4 for log and
dB scaling; the folded operands must equal the JAX fold exactly, since both
fold in float64 numpy and cast once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.config.model_format import ProcessingSpec
from syllable_detector_tpu.kernels import fused_detector as jfused
from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.kernels import fused_detector as tfused
from syllable_detector_tpu_torch.models import detector as tdet
from syllable_detector_tpu_torch.models.neural_net import params_from_numpy

torch.set_num_threads(1)

CASES = {case[0]: case for case in fixtures.fused_cases(seconds=1.0)}


def both(cfg, device="cpu"):
    """(port spec, port params, JAX spec, JAX params) from the same
    weights: the port's parameters are made from the JAX package's."""
    jspec, jparams = jdet.detector_spec_from_config(cfg)
    tspec, _ = tdet.detector_spec_from_config(cfg, device)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device)
    return tspec, tparams, jspec, jparams


def test_fusable_matches_jax():
    base = fixtures.sample_geometry_config(0)
    variants = [
        base,
        fixtures.gap_config(),
        fixtures.sample_geometry_config(0, scaling="db"),
        fixtures.sample_geometry_config(
            0, hidden=(8, 6), transfers=("LogSig", "SatLin", "PureLin")
        ),
        # l2normalize after an affine cannot fold
        dataclasses.replace(base, process_inputs=base.process_inputs[::-1]),
        dataclasses.replace(base, process_inputs=[ProcessingSpec("normalize")]),
    ]
    got = [tfused.fusable(tdet.detector_spec_from_config(c, "cpu")[0]) for c in variants]
    want = [jfused.fusable(jdet.detector_spec_from_config(c)[0]) for c in variants]
    assert got == want == [True, True, True, True, False, False]


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("name", ["linear", "deep"])
def test_fold_constants_matches_jax(name, pack):
    tspec, tparams, jspec, jparams = both(CASES[name][1])
    got = tfused.fold_constants(tspec, tparams, "cpu")
    ops, meta = jfused.fold_constants(jspec, jparams, pack=pack)
    b, hs = meta.b, meta.hs
    im0 = meta.b_pad // 2 if meta.packed else meta.b_pad
    eq = np.testing.assert_array_equal
    eq(got.c[:, :b].numpy(), ops[0][:, :b])
    eq(got.c[:, b:].numpy(), ops[0][:, im0 : im0 + b])
    h1 = got.c1.shape[0]
    for t in range(tspec.time_range):
        eq(got.w1[t].numpy(), ops[1][:b, t * hs : t * hs + h1])
    eq(got.c1.numpy(), ops[2][0, :h1])
    assert len(got.mids) == meta.n_mids
    for i, (w, bb) in enumerate(got.mids):
        n_in, n_out = w.shape
        eq(w.numpy(), ops[3 + 2 * i][:n_in, :n_out])
        eq(bb.numpy(), ops[4 + 2 * i][0, :n_out])
    n_out = tspec.net.outputs
    eq(got.out_a.numpy(), ops[-2][0, :n_out])
    eq(got.out_c.numpy(), ops[-1][0, :n_out])
    assert got.has_l2 == meta.has_l2
    flat = torch.cat([a.reshape(-1) for m in got.mids for a in m])
    eq(got.mids_flat.numpy(), flat.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax(name):
    _, cfg, x, rtol, atol = CASES[name]
    tspec, tparams, jspec, jparams = both(cfg)
    launches = tfused.LAUNCHES
    got = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x)).numpy()
    assert tfused.LAUNCHES == launches  # a CPU tensor never launches
    want_fused = np.asarray(
        jfused.fused_offline_outputs(
            jspec, jparams, jnp.asarray(x), interpret=True, tile=64
        )
    )
    want = np.asarray(jdet.offline_outputs(jspec, jparams, jnp.asarray(x)))
    assert got.shape == want_fused.shape == want.shape
    assert got.shape[0] > 0
    np.testing.assert_allclose(got, want_fused, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # NaN (digital silence, no epsilon in the l2 norm) in the same places
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_plain_version_too_short():
    tspec, tparams, jspec, jparams = both(CASES["linear"][1])
    for n in (0, 300, 1443):
        got = tfused.fused_offline_outputs(tspec, tparams, torch.zeros(n))
        want = jfused.fused_offline_outputs(jspec, jparams, jnp.zeros(n, jnp.float32))
        assert got.shape == want.shape == (0, 1)
    # exactly one evaluation
    x = fixtures.chirp_audio(1444 / 44100, 0)
    assert tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x)).shape == (1, 1)


@pytest.mark.parametrize("kw", [{}, {"input_mode": "frames"}, {"split": True}])
@pytest.mark.parametrize("name", ["linear", "gap"])
def test_n_evals_matches_jax(name, kw):
    """``n_evals`` shorter than the stream gives the first rows of the whole
    run (to float32 rounding), as the JAX function (interpret mode) does;
    more than the samples hold raises there and here."""
    _, cfg, x, rtol, atol = CASES[name]
    if kw.get("split"):
        rtol, atol = 2e-3, 5e-4  # the split tier's bound (fixtures.TIER_CASES)
    tspec, tparams, jspec, jparams = both(cfg)
    xt = torch.from_numpy(x)
    full = tfused.fused_offline_outputs(tspec, tparams, xt, **kw).numpy()
    for n_evals in (1, 17, len(full) - 1, len(full)):
        got = tfused.fused_offline_outputs(tspec, tparams, xt, n_evals=n_evals, **kw).numpy()
        want = np.asarray(jfused.fused_offline_outputs(
            jspec, jparams, jnp.asarray(x), interpret=True, tile=64, n_evals=n_evals, **kw))
        assert got.shape == want.shape == (n_evals, 1)
        # the CPU's matmuls block another shape otherwise: float32 rounding
        np.testing.assert_allclose(got, full[:n_evals], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert tfused.fused_offline_outputs(tspec, tparams, xt, n_evals=0).shape == (0, 1)
    too_many = f"n_evals={len(full) + 1} needs more than {len(x)} samples"
    with pytest.raises(ValueError, match=too_many):
        tfused.fused_offline_outputs(tspec, tparams, xt, n_evals=len(full) + 1, **kw)
    with pytest.raises(ValueError, match=too_many):
        jfused.fused_offline_outputs(jspec, jparams, jnp.asarray(x), n_evals=len(full) + 1, **kw)


@pytest.mark.parametrize("n_evals", [None, 3])
def test_unfusable_spec_takes_the_unfused_path(n_evals):
    """An input chain of ``normalize`` cannot fold: both functions run the
    unfused path and honour ``n_evals`` there (tests/test_kernels.py's
    ``test_unfusable_falls_back`` and ``..._honors_n_evals``)."""
    cfg = dataclasses.replace(
        fixtures.sample_geometry_config(0), process_inputs=[ProcessingSpec("normalize")]
    )
    tspec, tparams, jspec, jparams = both(cfg)
    assert not tfused.fusable(tspec) and not jfused.fusable(jspec)
    x = fixtures.chirp_audio(0.2, 3)
    counts = (tfused.LAUNCHES, dict(tfused.TIER_LAUNCHES), tfused.FRAMES_LAUNCHES)
    got = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x), n_evals=n_evals).numpy()
    assert counts == (tfused.LAUNCHES, dict(tfused.TIER_LAUNCHES), tfused.FRAMES_LAUNCHES)
    want = np.asarray(jfused.fused_offline_outputs(jspec, jparams, jnp.asarray(x), n_evals=n_evals))
    unfused = tdet.offline_outputs(tspec, tparams, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and len(got) == (len(unfused) if n_evals is None else n_evals)
    np.testing.assert_array_equal(got, unfused[: len(got)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="n_evals"):
        tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x), n_evals=len(unfused) + 1)
    # a precision tier does not apply to the unfused path
    tiered = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x), split=True,
                                        n_evals=n_evals).numpy()
    np.testing.assert_array_equal(tiered, got)


def test_rejects_unfusable_and_other_devices():
    base = fixtures.sample_geometry_config(0)
    cfg = dataclasses.replace(base, process_inputs=[ProcessingSpec("normalize")])
    spec, params = tdet.detector_spec_from_config(cfg, "cpu")
    with pytest.raises(ValueError, match="not fusable"):
        tfused.fold_constants(spec, params, "cpu")
    spec, params = tdet.detector_spec_from_config(base, "cpu")
    folded = tfused.fold_constants(spec, params, "meta")
    with pytest.raises(ValueError, match="no fused detector kernel"):
        tfused.fused_offline_outputs(
            spec, params, torch.zeros(5000, device="meta"), folded=folded
        )


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, cfg, x, rtol, atol in CASES.values():
        spec, params = tdet.detector_spec_from_config(cfg, "cuda")
        xd = torch.from_numpy(x).cuda()
        launches = tfused.LAUNCHES
        got = tfused.fused_offline_outputs(spec, params, xd)
        torch.cuda.synchronize()
        assert tfused.LAUNCHES == launches + 1
        folded = tfused.fold_constants(spec, params, "cuda")
        want = tfused.fused_offline_outputs_reference(spec, folded, xd)
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol,
            err_msg=name,
        )


# ---------------------------------------------------------------------------
# the fp32 kernel's tile choice, shared memory and 3xTF32 band DFT
# ---------------------------------------------------------------------------


def sample_spec():
    return tdet.detector_spec_from_config(CASES["linear"][1], "cpu")[0]


@pytest.mark.parametrize(
    "lanes,n_evals,frames",
    [
        (1, 497, 128),  # one CLI drain step: 5 CTAs
        (1, 20035, 128),  # a 60 s stream: 169 CTAs, one wave of two per SM
        (16, 31766, 128),  # the corpus scan's lanes
        (4, 31766, 128),  # one shard of it
        (1, 200444, 128),  # a 10-minute stream
        (256, 8, 64),  # live buckets, 256 lanes: one wave of small CTAs
        (256, 16, 64),
        (256, 32, 64),
        (256, 64, 128),  # 64 evaluations need two CTAs of 64 frames, one of 128
        (256, 128, 64),  # two waves either way: fewer frames in all
        (8, 128, 64),
    ],
)
def test_cta_frames_for_the_paths_launch_shapes(lanes, n_evals, frames):
    spec = sample_spec()
    got = tfused.cta_frames(spec, n_evals, lanes, 4)
    assert got == frames
    tile = got - spec.time_range + 1
    assert got % 64 == 0 and tile >= 1
    assert tfused.smem_bytes(spec, got, 4) <= tfused.SMEM_LIMIT

    def waves(f):  # two CTAs of 128 frames or three of 64 share an SM
        ctas = lanes * -(-n_evals // (f - spec.time_range + 1))
        return -(-ctas // (132 * {64: 3, 128: 2}[f]))

    assert all(waves(got) <= waves(f) for f in tfused.CTA_FRAMES)


def test_cta_frames_and_shared_memory_bounds():
    spec = sample_spec()
    sizes = [tfused.smem_bytes(spec, f, 4) for f in tfused.CTA_FRAMES]
    assert sizes == sorted(sizes)
    assert 2 * (sizes[-1] + 1024) <= tfused.SM_SMEM  # two CTAs of 128 frames an SM
    assert 3 * (sizes[0] + 1024) <= tfused.SM_SMEM  # three of 64
    # span + three 16-row stages of C's two halves, 64 columns + spectrogram
    # + row sums + activations
    span = -(-(127 * 132 + 256) // 4) * 4
    assert sizes[-1] == 4 * (span + 3 * 2 * 16 * 64 + 128 * 29 + 128 + 2 * 119 * 4)
    for name in CASES:
        s = tdet.detector_spec_from_config(CASES[name][1], "cpu")[0]
        width = max(w for _, w in s.net.layer_sizes)
        for lanes, n_evals in ((1, 1), (1, 3330), (3, 998), (160, 657)):
            frames = tfused.cta_frames(s, n_evals, lanes, width)
            assert frames in tfused.CTA_FRAMES
            assert tfused.smem_bytes(s, frames, width) <= tfused.SMEM_LIMIT
    # a timeRange above every choice takes the next multiple of 64; one that
    # cannot fit raises
    long = dataclasses.replace(spec, time_range=150)
    assert tfused.cta_frames(long, 1000, 1, 4) == 192
    with pytest.raises(ValueError, match="shared memory"):
        tfused.cta_frames(dataclasses.replace(spec, time_range=2000), 1000, 1, 4)


def test_tile_dft_matrix_layout():
    spec, params = tdet.detector_spec_from_config(CASES["linear"][1], "cpu")
    folded = tfused.fold_constants(spec, params, "cpu")
    b = spec.n_bins
    padded = tfused.pad_dft_matrix(folded.c)
    assert padded.shape == (256, 64) and padded.dtype == torch.float32
    for k in (0, 7, 8, 28):
        col = (k // 8) * 16 + k % 8
        np.testing.assert_array_equal(padded[:, col].numpy(), folded.c[:, k].numpy())
        np.testing.assert_array_equal(padded[:, col + 8].numpy(), folded.c[:, b + k].numpy())
    assert padded[:, 48 + 5 : 56].abs().sum() == 0 and padded[:, 56 + 5 :].abs().sum() == 0
    # the kernel's operand: both TF32 halves, a row block contiguous, inside
    # it the tensor cores' core matrices of 8 columns x 4 rows
    tiled = folded.c_tiled
    assert tiled.shape == (16, 2, 2, 1, 8, 2, 8, 4) and tiled.is_contiguous()
    hi, lo = tfused._tf32_hi_lo(padded)
    for r, c in ((0, 0), (37, 21), (255, 63), (100, 8)):
        at = (r // 16, slice(None), (r % 16) // 8, c // 64, (c % 64) // 8, (r % 8) // 4, c % 8, r % 4)
        assert tiled[at].tolist() == [float(hi[r, c]), float(lo[r, c])]
    gap_spec, gap_params = tdet.detector_spec_from_config(CASES["gap"][1], "cpu")
    gap = tfused.fold_constants(gap_spec, gap_params, "cpu")
    assert tfused.pad_dft_matrix(gap.c).shape == (64, 64)  # 24 bins: 48 columns, padded
    assert gap.c_tiled.shape == (4, 2, 2, 1, 8, 2, 8, 4)
    stacked = tfused.fold_constants_stacked(spec, [params, params], "cpu")
    np.testing.assert_array_equal(stacked.c_tiled.numpy(), tiled.numpy())
    # TF32 keeps 10 mantissa bits, rounded to nearest, ties away from zero
    v = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-11 - 2.0**-23, -1.0 - 2.0**-11, 3.14159265])
    got = tfused._tf32(v)
    assert got.tolist() == [1.0, 1.0 + 2.0**-10, 1.0, -1.0 - 2.0**-10, 3.140625]
    hi, lo = tfused._tf32_hi_lo(v)
    assert ((v - hi - lo).abs() <= v.abs() * 2.0**-21).all()


@pytest.mark.parametrize("name", list(CASES))
def test_three_tf32_products_reproduce_the_fp32_band_dft(name):
    """The kernel's band DFT arithmetic, emulated on the CPU: chirp frames
    and the padded C, each split into TF32 halves, three products. Bound:
    each dropped term (a_lo @ c_lo, and the rounding of the lo halves) is
    under 2^-21 of |a||c| per product, far below fp32's own rounding of a
    256-term sum; 5e-6 of the frame's largest magnitude holds all of it."""
    from syllable_detector_tpu.ops.stft import frame_signal as jframe_signal
    from syllable_detector_tpu.ops.stft import spectral_frames as jspectral_frames
    from syllable_detector_tpu_torch.ops.stft import frame_signal, num_frames, spectral_frames

    _, cfg, x, _, _ = CASES[name]
    spec, params = tdet.detector_spec_from_config(cfg, "cpu")
    folded = tfused.fold_constants(spec, params, "cpu")
    f = num_frames(len(x), spec.window_length, spec.window_overlap)
    frames = frame_signal(torch.from_numpy(x), f, spec.window_length, spec.window_overlap)
    b = spec.n_bins
    got = tfused.split_dft_reference(frames, folded.c)
    assert got.shape == (f, 2 * b)
    exact = frames.double() @ folded.c.double()
    scale = exact.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    assert float(((got.double() - exact).abs() / scale).max()) < 5e-6
    # one TF32 product alone is far worse: the split matters
    one = tfused._tf32(frames) @ tfused._tf32(folded.c)
    assert float(((one.double() - exact).abs() / scale).max()) > 5e-5
    mag = torch.sqrt(got[:, :b] ** 2 + got[:, b:] ** 2).numpy()
    want = spectral_frames(frames, spec.fourier_length, "hamming", spec.bins).numpy()
    jwant = np.asarray(
        jspectral_frames(
            jframe_signal(jnp.asarray(x), f, spec.window_length, spec.window_overlap),
            spec.fourier_length, "hamming", spec.bins,
        )
    )
    top = np.maximum(want.max(axis=1, keepdims=True), 1e-30)
    assert float((np.abs(mag - want) / top).max()) < 5e-6
    assert float((np.abs(mag - jwant) / top).max()) < 5e-6
