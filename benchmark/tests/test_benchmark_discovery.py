"""A cell, a configuration, a traffic kind or a per-layer metric is a file
found by its name: adding one needs no edit of a file that is there."""

import json
import shutil

import pytest

from benchmark import harness


@pytest.fixture
def folder(tmp_path, monkeypatch):
    """A copy of the benchmark's data files in which a test adds files."""
    for kind in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(harness.ROOT / kind, tmp_path / kind)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    return tmp_path


def test_a_new_workload_and_config_are_found_by_name(folder):
    geom = json.loads((folder / "configs" / "sample_44k.json").read_text())
    (folder / "configs" / "sample_44k_b.json").write_text(json.dumps(dict(geom, name="b")))
    wl = harness.load_json("workloads", "corpus_sample_mixed")
    wl.update(config="sample_44k_b", traffic_params=dict(wl["traffic_params"], rates=[44100]))
    (folder / "workloads" / "corpus_sample_b.json").write_text(json.dumps(wl))
    run, driver = harness.start("corpus_sample_b", 1, False, "cpu", 0.0)
    assert run.geom["name"] == "b" and run.params["rates"] == [44100]
    assert driver.__name__ == "benchmark_traffic_corpus"


def test_a_new_traffic_kind_is_found_by_name(folder):
    (folder / "traffic" / "echo.py").write_text("KIND = 'echo'\n")
    wl = dict(harness.load_json("workloads", "live_sample_16ch"), traffic="echo")
    (folder / "workloads" / "echo_cell.json").write_text(json.dumps(wl))
    _, driver = harness.start("echo_cell", 1, False, "cpu", 0.0)
    assert driver.KIND == "echo"


def test_a_new_metric_reader_is_found_by_name(folder):
    (folder / "metrics" / "live.rounds_n.py").write_text(
        "def read(run):\n    return len(run.work.get('round_counts', ())) or None\n")
    reader = harness.load_module("metrics", "live.rounds_n")

    class Run:
        work = {"round_counts": [[1], [1, 1]]}

    assert reader.read(Run()) == 2
    assert reader.read(type("Empty", (), {"work": {}})()) is None


def test_every_named_file_exists():
    spec = harness.benchmark_spec()
    for c in spec["configs"]:
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        wl = harness.load_json("workloads", w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (w["config"], w["traffic"], w["chips"])
        harness.load_module("traffic", wl["traffic"])
    for m in spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
