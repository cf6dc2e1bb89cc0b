"""The port's entry points and small host modules against the JAX
package's: the ``python -m`` dispatcher, ``inspect_net``, ``utils.logging``
and ``utils.synth``, on the CPU."""

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import syllable_detector_tpu.__main__ as jdispatch
import syllable_detector_tpu.inspect_net as jinspect
from syllable_detector_tpu.models.detector import (
    detector_spec_from_config as jspec_from,
    offline_outputs as joffline,
)
from syllable_detector_tpu.utils import logging as jlogging
from syllable_detector_tpu.utils import synth as jsynth
import syllable_detector_tpu_torch.__main__ as pdispatch
import syllable_detector_tpu_torch.inspect_net as pinspect
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.config.model_format import save_config
from syllable_detector_tpu_torch.models.detector import (
    detector_spec_from_config,
    offline_outputs,
)
from syllable_detector_tpu_torch.utils import logging as plogging
from syllable_detector_tpu_torch.utils import make_labeled_audio, synth as psynth

REPO = Path(__file__).resolve().parent.parent


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv,code", [([], 2), (["-h"], 0), (["--help"], 0), (["tune"], 2),
                                       (["frobnicate"], 2)])
def test_dispatcher_usage_matches_jax(argv, code):
    """The JAX dispatcher's usage text and return codes, every command
    included; ``tune`` without its required network exits as argparse does
    in both."""
    if argv == ["tune"]:
        for dispatch in (pdispatch, jdispatch):
            with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
                dispatch.main(argv)
            assert e.value.code == code
        argv = []
    rc, out, _ = run(pdispatch.main, argv)
    jrc, jout, _ = run(jdispatch.main, argv)
    assert rc == jrc == (code if argv else 2)
    want = [l.replace("syllable_detector_tpu ", "syllable_detector_tpu_torch ")
            for l in jout.splitlines()]
    got = out.splitlines()
    assert [l.split()[0] for l in got[3:]] == [l.split()[0] for l in want[3:]]
    # the descriptions of the commands whose backend differs are the port's own
    own = ("  dist-scan", "  tune")
    assert [l for l in got if not l.startswith(own)] == [l for l in want if not l.startswith(own)]
    assert set(pdispatch.COMMANDS) == set(jdispatch.COMMANDS)
    for name, (module, _) in pdispatch.COMMANDS.items():
        assert module == jdispatch.COMMANDS[name][0].replace(
            "syllable_detector_tpu.", "syllable_detector_tpu_torch.")


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    d = tmp_path_factory.mktemp("inspect")
    paths = {"sample": d / "sample.txt", "gap": d / "gap.txt", "bad": d / "bad.txt",
             "inputs": d / "inputs.txt"}
    save_config(fixtures.sample_geometry_config(0), paths["sample"])
    save_config(fixtures.gap_config(), paths["gap"])
    paths["bad"].write_text("samplingRate = 44100\n")
    # a parsable net whose input count disagrees with bins x timeRange
    paths["inputs"].write_text(
        paths["sample"].read_text().replace("timeRange = 10", "timeRange = 9"))
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("net", ["sample", "gap", "bad", "inputs"])
def test_inspect_matches_jax(nets, net):
    """``inspect_net.main`` prints the JAX module's text, stdout and stderr,
    with its return code."""
    got = run(pinspect.main, ["-n", nets[net]])
    want = run(jinspect.main, ["-n", nets[net]])
    assert got == want
    assert got[0] == (0 if net in ("sample", "gap") else 1)


def test_dispatch_reaches_tune(nets, tmp_path, monkeypatch):
    """``python -m syllable_detector_tpu_torch tune`` is ``tuning.main``: with
    its timer replaced it reports the fastest candidate beside the rule's
    choice and writes nothing; without a card it raises under the default
    ``--device cuda``."""
    from syllable_detector_tpu_torch import tuning

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(tuning, "_measure", lambda *a: {64: 2.0, 128: 1.0}[a[5]])
    rc, out, _ = run(pdispatch.main, ["tune", "-n", nets["sample"], "--workload", "single",
                                      "--device", "cpu"])
    assert rc == 0 and out.startswith("single: frames 128 ") and "; rule 128; " in out
    assert out.count("\n") == 1 and not any(tmp_path.rglob("*"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdispatch.main(["tune", "-n", nets["sample"]])


def test_dispatch_reaches_inspect(nets):
    rc, out, _ = run(pdispatch.main, ["inspect", "-n", nets["sample"]])
    assert rc == 0 and out == run(pinspect.main, ["-n", nets["sample"]])[1]
    assert "fused-kernel ready: True" in out
    proc = subprocess.run(
        [sys.executable, "-m", "syllable_detector_tpu_torch", "inspect", "-n", nets["gap"]],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout == run(pinspect.main, ["-n", nets["gap"]])[1]


@pytest.mark.parametrize("value", [None, "", "0", "false", "1", "yes"])
def test_dlog_gated_on_env(monkeypatch, value):
    """``dlog`` writes ``[file:line] message`` to stderr only when
    SYLLABLE_DETECTOR_DEBUG is set to something other than "", "0" or
    "false", as the JAX module does."""
    if value is None:
        monkeypatch.delenv("SYLLABLE_DETECTOR_DEBUG", raising=False)
    else:
        monkeypatch.setenv("SYLLABLE_DETECTOR_DEBUG", value)
    on = plogging.debug_enabled()
    assert on == jlogging.debug_enabled() == (value in ("1", "yes"))
    err = io.StringIO()
    line = sys._getframe().f_lineno + 2  # the dlog call's line
    with contextlib.redirect_stderr(err):
        plogging.dlog("hello")
    assert err.getvalue() == (f"[test_torch_entry.py:{line}] hello\n" if on else "")


def test_synth_matches_jax():
    """``make_labeled_audio`` (also exported from ``utils``) is the JAX
    generator, bit for bit; ``deepen_net`` grafts the same seeded layer onto
    a port ``DetectorSpec`` and the deepened nets agree through both
    packages' unfused paths (rtol=1e-4, atol=1e-5)."""
    for seconds, rate, seed in ((1.0, 44100, 0), (2.5, 44100, 7), (3.3, 48000, 5)):
        a, ia = make_labeled_audio(seconds, rate, seed=seed)
        b, ib = jsynth.make_labeled_audio(seconds, rate, seed=seed)
        np.testing.assert_array_equal(a, b)
        assert ia == ib and a.dtype == np.float32
    cfg = fixtures.sample_geometry_config(3)
    spec, params = detector_spec_from_config(cfg, "cpu")
    jspec, jparams = jspec_from(cfg)
    spec2, params2 = psynth.deepen_net(spec, params, mid_units=5, transfer="SatLin", seed=2)
    jspec2, jparams2 = jsynth.deepen_net(jspec, jparams, mid_units=5, transfer="SatLin", seed=2)
    assert spec2.net.layer_sizes == jspec2.net.layer_sizes
    assert spec2.net.transfers == jspec2.net.transfers == ("TanSig", "SatLin", "PureLin")
    for got, want in zip(params2["layers"], jparams2["layers"]):
        assert isinstance(got["w"], torch.Tensor)
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    x = fixtures.chirp_audio(0.5, 4)
    np.testing.assert_allclose(
        offline_outputs(spec2, params2, torch.from_numpy(x)).numpy(),
        np.asarray(joffline(jspec2, jparams2, jax.numpy.asarray(x))),
        rtol=1e-4, atol=1e-5)
