"""The port's ops, net and unfused detector against the JAX package's and
the NumPy oracle (tests/reference_impl.py), on the CPU.

Tolerance: rtol=1e-5, atol=1e-6 for float32 ops computed in another order
than the JAX package's; exact equality where both build the same float64
numpy constant and cast it once; 1e-4 against the oracle, which computes
the DFT in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_impl as ref
from syllable_detector_tpu.config.model_format import ProcessingSpec
from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu.models import neural_net as jnet
from syllable_detector_tpu.ops import processing as jproc
from syllable_detector_tpu.ops import scaling as jscaling
from syllable_detector_tpu.ops import stft as jstft
from syllable_detector_tpu.ops import transfer as jtransfer
from syllable_detector_tpu.ops import windows as jwindows
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.models import detector as tdet
from syllable_detector_tpu_torch.models import neural_net as tnet
from syllable_detector_tpu_torch.ops import processing as tproc
from syllable_detector_tpu_torch.ops import scaling as tscaling
from syllable_detector_tpu_torch.ops import stft as tstft
from syllable_detector_tpu_torch.ops import transfer as ttransfer
from syllable_detector_tpu_torch.ops import windows as twindows

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
# (window, overlap): the sample geometry, a gap, no overlap, a wide overlap
GEOMETRIES = [(256, 124), (64, -16), (64, 0), (128, 120)]


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["none", "hamming", "hanning", "blackman"])
def test_make_window(kind):
    got = twindows.make_window(kind, 256)
    np.testing.assert_array_equal(got, jwindows.make_window(kind, 256))
    close(got, ref.vdsp_window(kind, 256), atol=1e-7)


def test_make_window_rejects_bad_input():
    with pytest.raises(ValueError):
        twindows.make_window("hamming", 0)
    with pytest.raises(ValueError):
        twindows.make_window("kaiser", 8)


@pytest.mark.parametrize("window,overlap", GEOMETRIES)
def test_geometry_helpers(window, overlap):
    assert tstft.normalize_overlap(overlap) == jstft.normalize_overlap(overlap)
    assert tstft.hop_length(window, overlap) == jstft.hop_length(window, overlap)
    assert tstft.slab_parts(window, overlap) == jstft.slab_parts(window, overlap)
    for n in [0, window - 1, window, window + 16, 1000, 44100]:
        assert tstft.num_frames(n, window, overlap) == jstft.num_frames(
            n, window, overlap
        )


@pytest.mark.parametrize(
    "fft,f0,f1,rate",
    [
        (256, 2000.0, 7000.0, 44100.0),
        (64, 100.0, 3000.0, 8000.0),
        (256, 0.0, 30000.0, 44100.0),  # clamps to fft/2
        (256, 30000.0, 40000.0, 44100.0),  # starts above Nyquist
        (256, 500.0, 100.0, 44100.0),  # empty interval
    ],
)
def test_frequency_index_range(fft, f0, f1, rate):
    got = tstft.frequency_index_range(fft, f0, f1, rate)
    assert got == jstft.frequency_index_range(fft, f0, f1, rate)
    assert got == ref.freq_index_range(fft, f0, f1, rate)


@pytest.mark.parametrize("window,overlap", GEOMETRIES)
def test_frame_start_indices(window, overlap):
    for n_frames in (0, 1, 7, 333):
        got = tstft.frame_start_indices(n_frames, window, overlap)
        want = jstft.frame_start_indices(n_frames, window, overlap)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fft,rate", [(256, 44100.0), (64, 8000.0), (512, 96000), (128, 22050.5)])
def test_frequencies_for_sample_rate(fft, rate):
    from syllable_detector_tpu import ops as jops
    from syllable_detector_tpu_torch import ops as tops

    got = tops.frequencies_for_sample_rate(fft, rate)
    want = jops.frequencies_for_sample_rate(fft, rate)
    assert got.shape == want.shape == (fft // 2,) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tops.frequencies_for_sample_rate is tstft.frequencies_for_sample_rate


@pytest.mark.parametrize("window,overlap", GEOMETRIES)
def test_frame_signal(window, overlap):
    x = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    f = tstft.num_frames(len(x), window, overlap)
    # one frame more than the samples hold exercises the zero tail padding
    for n_frames in (f, f + 1):
        got = tstft.frame_signal(torch.from_numpy(x), n_frames, window, overlap)
        want = jstft.frame_signal(jnp.asarray(x), n_frames, window, overlap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_band_dft_matrices():
    for got, want in zip(
        tstft.band_dft_matrices(256, 256, "hamming", (12, 41)),
        jstft.band_dft_matrices(256, 256, "hamming", (12, 41)),
    ):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["matmul", "rfft"])
@pytest.mark.parametrize("kind", ["magnitude", "power"])
def test_spectral_frames(method, kind):
    x = np.random.default_rng(4).standard_normal(4000).astype(np.float32)
    f = tstft.num_frames(len(x), 256, 124)
    frames = tstft.frame_signal(torch.from_numpy(x), f, 256, 124)
    got = tstft.spectral_frames(
        frames, 256, "hamming", (12, 41), kind=kind, method=method
    )
    want = jstft.spectral_frames(
        jnp.asarray(frames.numpy()), 256, "hamming", (12, 41), kind=kind,
        method=method,
    )
    close(got, want)
    oracle = ref.stft_magnitudes(x, 256, 124, 256)[:, 12:41]
    close(got, oracle if kind == "magnitude" else oracle**2, rtol=1e-4, atol=1e-4)


def test_stack_features():
    band = np.random.default_rng(5).standard_normal((20, 29)).astype(np.float32)
    for t in (1, 10, 20, 21):
        got = tstft.stack_features(torch.from_numpy(band), t)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jstft.stack_features(jnp.asarray(band), t))
        )


@pytest.mark.parametrize("scaling", ["linear", "log", "db"])
def test_apply_scaling(scaling):
    x = np.random.default_rng(6).random(100).astype(np.float32) + 1e-3
    close(
        tscaling.apply_scaling(torch.from_numpy(x), scaling),
        jscaling.apply_scaling(jnp.asarray(x), scaling),
    )


@pytest.mark.parametrize("name", ["TanSig", "LogSig", "PureLin", "SatLin"])
def test_apply_transfer(name):
    x = np.random.default_rng(7).standard_normal(100).astype(np.float32) * 3
    close(
        ttransfer.apply_transfer(torch.from_numpy(x), name),
        jtransfer.apply_transfer(jnp.asarray(x), name),
    )


def _chain_specs(rng, d):
    affine = dict(
        x_offsets=rng.uniform(-1, 0, d), gains=rng.uniform(1, 3, d), y_offset=-1.0
    )
    return [
        ProcessingSpec("l2normalize"),
        ProcessingSpec("normalize"),
        ProcessingSpec("normalizestd"),
        ProcessingSpec("mapminmax", **affine),
        ProcessingSpec("mapstd", **affine),
    ]


@pytest.mark.parametrize("index", range(5))
def test_apply_named(index):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 12)).astype(np.float32)
    x[0] = 0.5  # a zero range row for 'normalize'
    spec = _chain_specs(rng, 12)[index]
    tnames, tparams = tproc.specs_to_chain([spec], "cpu")
    jnames, jparams = jproc.specs_to_chain([spec])
    close(
        tproc.apply_input_chain(torch.from_numpy(x), tnames, tparams),
        jproc.apply_input_chain(jnp.asarray(x), jnames, jparams),
    )


def test_reverse_output_chain():
    rng = np.random.default_rng(9)
    specs = _chain_specs(rng, 3)[3:]
    y = rng.standard_normal((5, 3)).astype(np.float32)
    close(
        tproc.reverse_output_chain(torch.from_numpy(y), *tproc.specs_to_chain(specs, "cpu")),
        jproc.reverse_output_chain(jnp.asarray(y), *jproc.specs_to_chain(specs)),
    )


def test_fold_affines():
    rng = np.random.default_rng(10)
    specs = [ProcessingSpec("l2normalize")] + _chain_specs(rng, 12)[3:]
    tnames, tparams = tproc.specs_to_chain(specs, "cpu")
    jnames, jparams = jproc.specs_to_chain(specs)
    for got, want in zip(
        tproc.fold_input_affines(tnames, tparams, 12),
        jproc.fold_input_affines(jnames, jparams, 12),
    ):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
        tproc.fold_output_affines(tnames, tparams, 12),
        jproc.fold_output_affines(jnames, jparams, 12),
    ):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hidden", [(4,), (8, 6)])
def test_apply_net(hidden):
    transfers = ("TanSig", "PureLin") if len(hidden) == 1 else ("LogSig", "SatLin", "PureLin")
    cfg = fixtures.sample_geometry_config(1, hidden=hidden, transfers=transfers)
    x = (np.random.default_rng(11).random((5, 290)) * 1e-2).astype(np.float32)
    tspec, tparams = tnet.net_from_config(cfg, "cpu")
    jspec, jparams = jnet.net_from_config(cfg)
    got = tnet.apply_net(tspec, tparams, torch.from_numpy(x))
    close(got, jnet.apply_net(jspec, jparams, jnp.asarray(x)))
    close(got, np.stack([ref.net_apply(cfg, xi) for xi in x]), rtol=1e-4)


def test_params_from_numpy_matches_config():
    cfg = fixtures.sample_geometry_config(2)
    _, jparams = jnet.net_from_config(cfg)
    from_jax = tnet.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    _, direct = tnet.net_from_config(cfg, "cpu")
    flat_a = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), from_jax))
    flat_b = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), direct))
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_detector_spec_checks():
    cfg = fixtures.sample_geometry_config(3)
    tspec, _ = tdet.detector_spec_from_config(cfg, "cpu")
    jspec, _ = jdet.detector_spec_from_config(cfg)
    assert tspec.bins == jspec.bins == (12, 41)
    assert tspec.hop == jspec.hop == 132
    assert tspec.first_output_sample == jspec.first_output_sample == 1444
    bad = [
        dataclasses.replace(cfg, freq_range=(7000.0, 2000.0)),
        dataclasses.replace(cfg, freq_range=(2000.0, 8000.0)),
        dataclasses.replace(cfg, thresholds=[0.5, 0.5]),
    ]
    for c in bad:
        with pytest.raises(ValueError) as want:
            jdet.detector_spec_from_config(c)
        with pytest.raises(ValueError) as got:
            tdet.detector_spec_from_config(c, "cpu")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("method", ["matmul", "rfft"])
@pytest.mark.parametrize("scaling", ["linear", "db"])
def test_offline_outputs(method, scaling):
    cfg = fixtures.sample_geometry_config(4, scaling=scaling)
    x = fixtures.chirp_audio(0.5, seed=5)
    tspec, tparams = tdet.detector_spec_from_config(cfg, "cpu")
    jspec, jparams = jdet.detector_spec_from_config(cfg)
    got = tdet.offline_outputs(tspec, tparams, torch.from_numpy(x), method=method)
    want = jdet.offline_outputs(jspec, jparams, jnp.asarray(x), method=method)
    assert np.isnan(got.numpy()).any()  # the silent stretch
    # the whole pipeline, not one op: the folded mapminmax gains amplify
    # float32 reordering of the band sums, so the CLI's own output
    # tolerance applies (tests/test_cli_golden.py)
    close(got, want, rtol=1e-4, atol=1e-5)
    close(got, ref.detect_offline(cfg, x), rtol=1e-4, atol=1e-4)


def test_offline_outputs_too_short():
    cfg = fixtures.sample_geometry_config(4)
    tspec, tparams = tdet.detector_spec_from_config(cfg, "cpu")
    for n in (0, 300, 1443):
        got = tdet.offline_outputs(tspec, tparams, torch.zeros(n))
        assert got.shape == (0, 1)
