"""The port's framed GEMM and polyphase resampler against the JAX package's.

The plain version of the framed GEMM kernel is held against the JAX Pallas
kernel (interpret mode) and against ``frame_signal @ g`` on the six
framings of tests/test_framed_gemm.py, within that file's rtol=1e-4,
atol=1e-4. The port's ``polyphase_resample`` on the CPU is held against the
JAX XLA path and the Pallas path at rtol=1e-5, atol=1e-5; its float64 plan
must be the JAX plan exactly. Interpret mode is slow, so inputs stay at or
under 9000 samples.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.kernels.framed_gemm import framed_gemm as jframed_gemm
from syllable_detector_tpu.kernels.framed_gemm import pallas_polyphase_resample
from syllable_detector_tpu.ops import resample as jresample
from syllable_detector_tpu.ops.stft import frame_signal as jframe_signal
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.kernels import framed_gemm as tfg
from syllable_detector_tpu_torch.ops import resample as tresample
from syllable_detector_tpu_torch.ops.stft import num_frames

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
