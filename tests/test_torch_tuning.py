"""The port's tuner (``tuning.py``): the cache and its keys against the JAX
module's, the lookup ``kernels/fused_detector.cta_frames`` makes before its
analytic choice, and ``main`` with the timer replaced (the real timer needs a
card: CUDA events on the kernel)."""

import dataclasses
import json
import os
import subprocess
import sys
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
def tune_cache(tmp_path, monkeypatch):
    path = tmp_path / "cache" / "tune.json"
    monkeypatch.setenv("SD_TUNE_CACHE", str(path))
    tuning.reset_tune_cache()
    yield path
    tuning.reset_tune_cache()


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


def test_cache_path_default_and_override(monkeypatch, tmp_path):
    monkeypatch.delenv("SD_TUNE_CACHE", raising=False)
    assert tuning.tune_cache_path() == os.path.expanduser(
        "~/.cache/syllable_detector_tpu_torch/tune.json")
    monkeypatch.setenv("SD_TUNE_CACHE", str(tmp_path / "t.json"))
    assert tuning.tune_cache_path() == str(tmp_path / "t.json")


def test_cache_round_trip_and_buckets(spec, tune_cache):
    ms = {64: 0.5, 128: 0.3}
    trials = tuning.tune_cta_frames(spec, None, "batched", 64, 2048, measure=ms.get,
                                    device="cpu")
    assert [t.tile for t in trials] == [128, 64]
    assert trials[0].windows_per_s == pytest.approx(64 * 2048 / 0.3e-3)
    entry = json.loads(tune_cache.read_text())[tuning.tune_key("cpu", spec, "batched", 64, 2048)]
    assert entry["frames"] == 128 and entry["analytic"] == fused.cta_frames(spec, 2048, 64, 4)
    assert entry["trials"] == [[128, 0.3], [64, 0.5]]
    # a power-of-two bucket covers the neighbourhood; other keys miss
    assert tuning.tuned_cta_frames("cpu", spec, "batched", 40, 1500) == 128
    assert tuning.tuned_cta_frames("cpu", spec, "batched", 640, 2048) is None
    assert tuning.tuned_cta_frames("cpu", spec, "distinct", 64, 2048) is None
    assert tuning.tuned_cta_frames("cuda:other", spec, "batched", 64, 2048) is None


def test_corrupt_cache_is_ignored(spec, tune_cache):
    tune_cache.parent.mkdir(parents=True)
    for text in ("{not json", "[1, 2]"):
        tune_cache.write_text(text)
        tuning.reset_tune_cache()
        assert tuning.tuned_cta_frames("cpu", spec, "batched", 64, 2048) is None
    tuning.tune_cta_frames(spec, None, "single", 1, 4096, measure=lambda f: 1.0 / f,
                           device="cpu")
    assert tuning.tuned_cta_frames("cpu", spec, "single", 1, 4096) == 128


def test_concurrent_writers_keep_every_entry(spec, tune_cache):
    """Writers in four processes at once, and one whose in-process copy
    predates them: every entry survives the read-modify-write."""
    tuning.tune_cta_frames(spec, None, "batched", 8, 64, measure=lambda f: 1.0, device="cpu")
    assert tuning.tuned_cta_frames("cpu", spec, "batched", 8, 64) == 64  # memoized now
    script = (
        "import sys\n"
        "from syllable_detector_tpu_torch import fixtures, tuning\n"
        "from syllable_detector_tpu_torch.models.detector import detector_spec_from_config\n"
        "spec = detector_spec_from_config(fixtures.sample_geometry_config(0), 'cpu')[0]\n"
        "w = int(sys.argv[1])\n"
        "for k in range(5):\n"
        "    tuning.tune_cta_frames(spec, None, 'batched', 16 << w, 64 << k,\n"
        "                           measure=lambda f: 1.0, device='cpu')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(w)], env=env, cwd=REPO)
             for w in range(4)]
    try:
        for p in procs:
            assert p.wait(timeout=120) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    tuning.tune_cta_frames(spec, None, "distinct", 8, 64, measure=lambda f: 1.0, device="cpu")
    assert len(json.loads(tune_cache.read_text())) == 1 + 4 * 5 + 1


def test_cta_frames_consults_the_cache(spec, tune_cache):
    """A cached winner replaces the analytic choice for its card and
    workload, in full fp32 from samples only; one that does not fit is
    ignored."""
    analytic = fused.cta_frames(spec, 2048, 64, 4)
    other = 128 if analytic == 64 else 64
    tuning.tune_cta_frames(spec, None, "distinct", 64, 2048,
                           measure=lambda f: 0.1 if f == other else 1.0, device="cpu")
    kw = dict(workload="distinct", device_kind="cpu")
    assert fused.cta_frames(spec, 2048, 64, 4, **kw) == other
    assert fused.cta_frames(spec, 2048, 64, 4) == analytic
    assert fused.cta_frames(spec, 2048, 64, 4, workload="batched", device_kind="cpu") == analytic
    assert fused.cta_frames(spec, 2048, 64, 4, tier="split", **kw) == fused.cta_frames(
        spec, 2048, 64, 4, tier="split")
    assert fused.cta_frames(spec, 2048, 64, 4, frames_input=True, **kw) == fused.cta_frames(
        spec, 2048, 64, 4, frames_input=True)
    key = tuning.tune_key("cpu", spec, "distinct", 64, 2048)
    for bad in (4096, 96, "x"):  # too much shared memory, not a multiple of 64, garbage
        cache = json.loads(tune_cache.read_text())
        cache[key]["frames"] = bad
        tune_cache.write_text(json.dumps(cache))
        tuning.reset_tune_cache()
        assert fused.cta_frames(spec, 2048, 64, 4, **kw) == analytic


@pytest.fixture
def net(tmp_path):
    path = tmp_path / "net.txt"
    save_config(fixtures.sample_geometry_config(0), path)
    return str(path)


def test_main_picks_and_persists_the_fastest(net, tune_cache, monkeypatch, capsys):
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
    assert all(" frames 64 " in line for line in out)
    spec = detector_spec_from_config(fixtures.sample_geometry_config(0), "cpu")[0]
    for workload, lanes, n_evals in (("batched", 64, 2048), ("distinct", 64, 2048),
                                     ("single", 1, tuning.SINGLE_EVALS)):
        assert tuning.tuned_cta_frames("cpu", spec, workload, lanes, n_evals) == 64


def test_main_errors_when_no_candidate_fits(net, tune_cache, monkeypatch, capsys):
    monkeypatch.setattr(tuning, "_measure", lambda *a: pytest.fail("nothing should be timed"))
    assert tuning.main(["-n", net, "--tiles", "100", "4096", "--workload", "single",
                        "--device", "cpu"]) == 1
    assert not tune_cache.exists()
    err = capsys.readouterr().err
    assert "not a multiple of 64" in err and "shared memory" in err
    assert "no candidate fits" in err


def test_main_needs_a_card(net, tune_cache):
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
