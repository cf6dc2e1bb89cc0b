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
