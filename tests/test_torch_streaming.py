"""The port's fixed-shape streaming (``streaming_init`` / ``streaming_step``
/ ``streaming_scan``) against the JAX package's and against the port's own
``offline_outputs``, on the CPU.

Inputs come from a numpy seed and go through both packages. Tolerance:
rtol=1e-4, atol=1e-5, the port's standing contract for its unfused fp32
paths against the JAX functions; NaN (digital silence under l2normalize)
must fall in the same places. Against ``offline_outputs`` of the same
package the scan evaluates the same windows with the same operations, so
it is held to rtol=1e-6, atol=1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.models import detector as tdet
from test_torch_fused_detector import both

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5

CONFIGS = {
    "sample": lambda: fixtures.sample_geometry_config(3),
    "db": lambda: fixtures.sample_geometry_config(3, scaling="db"),
    "gap": fixtures.gap_config,
}


def audio(name: str, seconds: float = 0.5) -> np.ndarray:
    if name == "gap":
        return np.random.default_rng(5).standard_normal(int(seconds * 8000)).astype(np.float32)
    return fixtures.chirp_audio(seconds, 6)


def close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("chunk_hops", [16, 5])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_streaming_scan_matches_jax_and_offline(name, chunk_hops):
    tspec, tparams, jspec, jparams = both(CONFIGS[name]())
    x = audio(name)
    got = tdet.streaming_scan(tspec, tparams, torch.from_numpy(x), chunk_hops=chunk_hops)
    want = jdet.streaming_scan(jspec, jparams, jnp.asarray(x), chunk_hops=chunk_hops)
    assert len(got) > 40
    close(got.numpy(), want)
    offline = tdet.offline_outputs(tspec, tparams, torch.from_numpy(x))
    close(got.numpy(), offline.numpy(), rtol=1e-6, atol=1e-6)
    assert tspec.residual == jspec.residual


@pytest.mark.parametrize("method", ["matmul", "rfft"])
def test_streaming_scan_methods_and_short_streams(method):
    tspec, tparams, jspec, jparams = both(CONFIGS["sample"]())
    x = audio("sample", 0.2)
    got = tdet.streaming_scan(tspec, tparams, torch.from_numpy(x), method=method)
    close(got.numpy(), jdet.streaming_scan(jspec, jparams, jnp.asarray(x), method=method))
    for n in (0, 100, 1443):  # no evaluation fits
        short = tdet.streaming_scan(tspec, tparams, torch.from_numpy(x[:n]), method=method)
        assert short.shape == (0, 1)
        assert jdet.streaming_scan(jspec, jparams, jnp.asarray(x[:n]), method=method).shape == (0, 1)


@pytest.mark.parametrize("with_prefix", [False, True], ids=["zeros", "prefix"])
@pytest.mark.parametrize("name", ["sample", "gap"])
def test_streaming_step_matches_jax(name, with_prefix):
    tspec, tparams, jspec, jparams = both(CONFIGS[name]())
    x = audio(name)
    r, hop = tspec.residual, tspec.hop
    start = r if with_prefix else 0
    tcarry = tdet.streaming_init(tspec, torch.from_numpy(x[:r]) if with_prefix else None, device="cpu")
    jcarry = jdet.streaming_init(jspec, jnp.asarray(x[:r]) if with_prefix else None)
    close(tcarry["residual"].numpy(), jcarry["residual"])
    rows = []
    for step, hops in enumerate((7, 7, 12)):
        chunk = x[start : start + hops * hop]
        start += hops * hop
        tcarry, tout = tdet.streaming_step(tspec, tparams, tcarry, torch.from_numpy(chunk))
        jcarry, jout = jdet.streaming_step(jspec, jparams, jcarry, jnp.asarray(chunk))
        assert tout.shape == (hops, 1)
        # rows before the feature window fills see the zero history: under
        # l2normalize they may be NaN, in the same places in both
        close(tout.numpy(), jout)
        for key in ("residual", "history"):
            close(tcarry[key].numpy(), jcarry[key])
        rows.append(tout)
    if with_prefix:
        # past the warm-up the steps give the offline outputs of the stream
        offline = tdet.offline_outputs(tspec, tparams, torch.from_numpy(x[:start]))
        got = torch.cat(rows)[tspec.history :]
        close(got.numpy(), offline[: len(got)].numpy(), rtol=1e-6, atol=1e-6)


def test_streaming_rejects_bad_shapes():
    tspec, tparams, jspec, jparams = both(CONFIGS["sample"]())
    with pytest.raises(ValueError, match="first 124 samples"):
        tdet.streaming_init(tspec, torch.zeros(100))
    with pytest.raises(ValueError, match="first 124 samples"):
        jdet.streaming_init(jspec, jnp.zeros(100))
    carry = tdet.streaming_init(tspec, device="cpu")
    assert carry["residual"].shape == (124,) and carry["history"].shape == (9, 29)
    with pytest.raises(ValueError, match="multiple of the hop"):
        tdet.streaming_step(tspec, tparams, carry, torch.zeros(133))
    with pytest.raises(ValueError, match="multiple of the hop"):
        jdet.streaming_step(jspec, jparams, jdet.streaming_init(jspec), jnp.zeros(133))
