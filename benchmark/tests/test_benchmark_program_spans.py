"""The readers of the port's own spans on synthetic runs: shares of the
window's wall clipped to the window, count ratios, and None where the ring
dropped spans inside the window or the program has no ring."""

import types

import pytest

from benchmark import harness, program_spans
from syllable_detector_tpu_torch.utils import timing

S = 10**9  # ns a second; the window runs from 100 s to 110 s
NEW = {"corpus.read_share": 0.1, "corpus.stage_share": 0.2, "corpus.copy_in_share": 0.05,
       "corpus.pad_share": 1 - 2646000 / 4194304, "corpus.csv_yield": 0.01,
       "train.features_share": 0.03, "train.capture_share": 0.04,
       "train.indices_share": 0.02, "train.device_wait_share": 0.8}


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    monkeypatch.setattr(timing, "_RING", timing._Ring(64))


def run():
    return types.SimpleNamespace(window=(100.0, 110.0))


def at(name, a, b, **counts):
    timing.record(name, round(a * S), round(b * S), **counts)


def test_shares_clip_to_the_window_and_count_overlaps_once():
    at("x", 99.0, 101.0)  # 1 s inside
    at("x", 105.0, 106.0)
    at("x", 105.5, 106.5)  # 0.5 s more than the span before
    at("x", 109.5, 111.0)  # 0.5 s inside
    at("y", 90.0, 99.0)  # outside
    assert program_spans.share(run(), "x") == pytest.approx(0.3)
    assert program_spans.share(run(), "y") is None
    assert program_spans.share(run(), "z") is None


def test_counts_sum_the_spans_that_ended_inside():
    at("c", 99.0, 99.5, rows=1000, lines=1)  # ended before the window
    at("c", 101.0, 102.0, rows=100, lines=2)
    at("c", 103.0, 104.0, rows=300, lines=6)
    at("c", 109.0, 111.0, rows=7, lines=7)  # ends after it
    assert program_spans.counts(run(), "c", "lines", "rows") == [8, 400]
    assert program_spans.counts(run(), "c", "pages") is None


def test_none_where_the_ring_dropped_spans_inside_the_window(monkeypatch):
    monkeypatch.setattr(timing, "_RING", timing._Ring(4))
    at("x", 90.0, 91.0)
    at("x", 92.0, 93.0)
    for k in range(4):
        at("x", 101.0 + k, 101.5 + k)
    assert timing.drops() == (2, 93 * S)  # both before the window
    assert program_spans.share(run(), "x") == pytest.approx(0.2)
    at("x", 106.0, 106.5)  # drops one from inside the window
    assert program_spans.window_spans(run()) is None
    assert program_spans.share(run(), "x") is None
    assert program_spans.counts(run(), "x") is None


def test_a_program_without_the_ring_gives_none(monkeypatch):
    at("corpus.read", 101.0, 102.0)
    monkeypatch.delattr(timing, "spans")
    assert harness.load_module("metrics", "corpus.read_share").read(run()) is None


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_new_reader(metric):
    at("corpus.read", 101.0, 102.0)
    at("corpus.stage", 102.0, 104.0, lanes=16, samples=16 * 2646000,
       staged_samples=16 * 4194304)
    at("corpus.copy_in", 104.0, 104.5)
    at("corpus.csv", 104.5, 105.0, rows=1000, lines=10)
    at("train.features", 105.0, 105.3)
    at("trainer.capture", 105.3, 105.7)
    at("trainer.indices", 105.7, 105.9)
    at("trainer.device_wait", 101.0, 109.0)
    reader = harness.load_module("metrics", metric)
    assert reader.read(run()) == pytest.approx(NEW[metric])
    timing.Time.reset()
    assert reader.read(run()) is None


def test_the_new_metrics_are_declared():
    spec = {m["name"]: m for m in harness.benchmark_spec()["per_layer"]}
    for name in NEW:
        m = spec[name]
        assert m["source"] == "program_span" and m["unit"] == "fraction"
        assert m["workloads"] == (["corpus_sample_mixed"] if name.startswith("corpus.")
                                  else ["train_sample_defaults"])
