"""The port's package exports against the JAX package's: every name in the
``__all__`` of the JAX package and of its ``kernels``, ``models``, ``ops``,
``runtime`` and ``utils`` packages is an attribute of the port's package of
the same path, and each class or function is the object the port's defining
submodule holds. Three names are TPU layout with no counterpart (ROADMAP,
"Do not port")."""

import importlib
import inspect

import pytest

PACKAGES = ["", "kernels", "models", "ops", "runtime", "utils"]
# TPU layout: the stream length at which the TPU path pads nothing, the
# pre-slabbed flat input's length, and the Pallas entry of the resampler,
# whose behaviour is ops.resample.polyphase_resample on the framed GEMM kernel
NOT_PORTED = {"flat_batch_input_samples", "fused_input_samples", "pallas_polyphase_resample"}


def _module(package: str, root: str):
    return importlib.import_module(f"{root}.{package}" if package else root)


@pytest.mark.parametrize("package", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_package_exports_match_jax(package):
    jax_pkg = _module(package, "syllable_detector_tpu")
    port = _module(package, "syllable_detector_tpu_torch")
    wanted = [n for n in jax_pkg.__all__ if n not in NOT_PORTED]
    assert wanted
    missing = [n for n in wanted if not hasattr(port, n)]
    assert not missing, missing
    assert set(port.__all__) == set(wanted)
    for name in wanted:
        obj = getattr(port, name)
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        home = importlib.import_module(obj.__module__)
        assert home.__name__.startswith(port.__name__), (name, home.__name__)
        assert getattr(home, name) is obj, name
