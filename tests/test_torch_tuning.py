"""The port's launch-shape report (``tuning.py``): its geometry key against
the JAX module's, ``main`` with the timer replaced (the real timer needs a
card: CUDA events on the kernel), and the kernel layer's launch shape, which
reads no file and imports nothing above the kernel layer."""

import ast
import builtins
import dataclasses
import json
import os
from pathlib import Path

import pytest

from syllable_detector_tpu.config.model_format import loads_config as jloads
from syllable_detector_tpu.models.detector import detector_spec_from_config as jspec_from
from syllable_detector_tpu.tuning import geometry_key as jgeometry_key
from syllable_detector_tpu_torch import fixtures, tuning
from syllable_detector_tpu_torch.config.model_format import dumps_config, save_config
from syllable_detector_tpu_torch.kernels import fused_detector as fused
from syllable_detector_tpu_torch.models.detector import detector_spec_from_config

REPO = Path(__file__).resolve().parent.parent
CONFIGS = {
    "sample": lambda: fixtures.sample_geometry_config(0),
    "deep-log": lambda: fixtures.sample_geometry_config(
        3, hidden=(8, 6), transfers=("LogSig", "SatLin", "PureLin"), scaling="log"),
    "gap": fixtures.gap_config,
}


@pytest.fixture
def home(tmp_path, monkeypatch):
    """An empty ``HOME`` of the test's own."""
    path = tmp_path / "home"
    path.mkdir()
    monkeypatch.setenv("HOME", str(path))
    return path


@pytest.fixture
def spec():
    return detector_spec_from_config(fixtures.sample_geometry_config(0), "cpu")[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_geometry_key_matches_jax(name):
    cfg = CONFIGS[name]()
    spec = detector_spec_from_config(cfg, "cpu")[0]
    assert tuning.geometry_key(spec) == jgeometry_key(jspec_from(jloads(dumps_config(cfg)))[0])
    longer = dataclasses.replace(spec, time_range=spec.time_range + 1)
    assert tuning.geometry_key(longer) != tuning.geometry_key(spec)


def test_launch_shape_reads_no_tune_file(spec, home, tmp_path, monkeypatch):
    """A ``tune.json`` naming 64 frames for every workload, where the tuner
    once kept its cache (``$HOME/.cache/...`` and ``$SD_TUNE_CACHE``), is
    not opened, and each launch keeps the rule's shape: 128 frames, the
    resident layout."""
    width = max(w for _, w in spec.net.layer_sizes)
    shapes = {"single": (1, tuning.SINGLE_EVALS), "batched": (64, 2048),
              "distinct": (64, 2048)}
    entries = {f"r{r}/{kind}/{tuning.geometry_key(spec)}/{w}/c{max(8, lanes)}/ne{evals}":
               {"frames": 64}
               for r in range(1, 5) for kind in ("cpu", "cuda:NVIDIA H100 80GB HBM3")
               for w, (lanes, evals) in shapes.items()}
    files = [home / ".cache" / "syllable_detector_tpu_torch" / "tune.json",
             tmp_path / "elsewhere" / "tune.json"]
    for f in files:
        f.parent.mkdir(parents=True)
        f.write_text(json.dumps(entries))
    monkeypatch.setenv("SD_TUNE_CACHE", str(files[1]))
    opened, real_open = [], builtins.open
    monkeypatch.setattr(builtins, "open", lambda f, *a, **k: opened.append(f)
                        or real_open(f, *a, **k))
    for lanes, evals in shapes.values():
        assert fused.cta_choice(spec, evals, lanes, width) == fused.CtaChoice(128, 0)
        assert fused.cta_frames(spec, evals, lanes, width) == 128
    assert opened == []


@pytest.mark.parametrize("workload", tuning.WORKLOADS)
def test_tune_writes_no_file(net, home, tmp_path, monkeypatch, workload, capsys):
    """``tune`` times, reports and writes nothing: not under ``HOME``, not
    at ``$SD_TUNE_CACHE``, not in the working directory."""
    cached = tmp_path / "cache" / "tune.json"
    monkeypatch.setenv("SD_TUNE_CACHE", str(cached))
    monkeypatch.setattr(tuning, "_measure", lambda *a: {64: 0.2, 128: 0.1}[a[5]])
    here = sorted(os.listdir())
    assert tuning.main(["-n", net, "--workload", workload, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(f"{workload}: frames 128 ")
    assert not any(home.rglob("*")) and not cached.parent.exists()
    assert sorted(os.listdir()) == here


def test_tune_reports_the_rules_choice(spec, net, home, monkeypatch, capsys):
    """Each workload's line gives the fastest, the rule's choice for that
    launch and every trial; the report does not move the rule."""
    width = max(w for _, w in spec.net.layer_sizes)
    trials, rule = tuning.tune_cta_frames(spec, None, "distinct", 64, 2048,
                                          measure={64: 0.5, 128: 0.8}.get, device="cpu")
    assert [(t.tile, t.ms) for t in trials] == [(64, 0.5), (128, 0.8)]
    assert trials[0].windows_per_s == pytest.approx(64 * 2048 / 0.5e-3)
    assert rule == fused.cta_frames(spec, 2048, 64, width) == 128
    monkeypatch.setattr(tuning, "_measure", lambda *a: {64: 0.5, 128: 0.8}[a[5]])
    assert tuning.main(["-n", net, "--workload", "all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["batched", "distinct", "single"]
    for line, shape in zip(out, ("64 x 2048", "64 x 2048", f"1 x {tuning.SINGLE_EVALS}")):
        assert " frames 64 0.5000 ms " in line and "; rule 128; " in line
        assert line.endswith(f"{shape}: frames 64 0.5000 ms, frames 128 0.8000 ms")
    assert fused.cta_frames(spec, 2048, 64, width) == 128


def test_kernels_import_nothing_above_them():
    """Every import of the package in ``kernels/*.py``, lazy ones inside
    functions too, is of ``kernels``, ``ops`` or ``models.detector``: the
    launch shape cannot depend on a command module such as ``tuning``."""
    root = REPO / "syllable_detector_tpu_torch"
    allowed = ("kernels", "ops", "models.detector")
    seen = []
    for path in sorted((root / "kernels").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if not node.level else ["<relative>"]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            for name in names:
                if name == "<relative>" or name.split(".")[0] == root.name:
                    seen.append((path.name, name))
    assert seen
    above = [(f, m) for f, m in seen
             if not any(m == f"{root.name}.{a}" or m.startswith(f"{root.name}.{a}.")
                        for a in allowed)]
    assert above == []


@pytest.fixture
def net(tmp_path):
    path = tmp_path / "net.txt"
    save_config(fixtures.sample_geometry_config(0), path)
    return str(path)


def test_main_reports_the_fastest(net, home, monkeypatch, capsys):
    calls = []

    def fake_measure(spec, params, workload, lanes, n_evals, frames, device):
        calls.append((workload, lanes, n_evals, frames, type(params).__name__))
        return {64: 0.2, 128: 0.4}[frames] * (2 if workload == "single" else 1)

    monkeypatch.setattr(tuning, "_measure", fake_measure)
    assert tuning.main(["-n", net, "--workload", "all", "--device", "cpu"]) == 0
    assert {(w, l, n, p) for w, l, n, _, p in calls} == {
        ("batched", 64, 2048, "dict"), ("distinct", 64, 2048, "list"),
        ("single", 1, tuning.SINGLE_EVALS, "dict")}
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["batched", "distinct", "single"]
    assert all(line.split(";")[0].split(": ")[1].startswith("frames 64 ") for line in out)
    assert not any(home.rglob("*"))


def test_main_errors_when_no_candidate_fits(net, home, monkeypatch, capsys):
    monkeypatch.setattr(tuning, "_measure", lambda *a: pytest.fail("nothing should be timed"))
    assert tuning.main(["-n", net, "--tiles", "100", "4096", "--workload", "single",
                        "--device", "cpu"]) == 1
    assert not any(home.rglob("*"))
    err = capsys.readouterr().err
    assert "not a multiple of 64" in err and "shared memory" in err
    assert "no candidate fits" in err


def test_main_needs_a_card(net):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.main(["-n", net])
    with pytest.raises(RuntimeError, match="on a card"):
        tuning._measure(None, None, "single", 1, 8, 64, "cpu")


def test_measure_helpers_match_jax():
    """make_audio is the JAX module's; perturbed_params draws the same
    numbers for the same leaves, so both packages perturb a net alike."""
    import jax
    import numpy as np

    from syllable_detector_tpu.utils import measure as jmeasure
    from syllable_detector_tpu_torch.utils import measure

    np.testing.assert_array_equal(measure.make_audio(5000, seed=3),
                                  jmeasure.make_audio(5000, seed=3))
    cfg = fixtures.sample_geometry_config(2, hidden=(8, 6), transfers=("LogSig", "SatLin", "PureLin"))
    params = detector_spec_from_config(cfg, "cpu")[1]
    jparams = jspec_from(jloads(dumps_config(cfg)))[1]
    got = measure.perturbed_params(params, 7)
    want = jmeasure.perturbed_params(jparams, 7)
    got_leaves = []

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                leaves(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                leaves(v)
        else:
            got_leaves.append(tree)

    leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(got_leaves[-1].numpy(), jax.tree.leaves(jparams)[-1])
