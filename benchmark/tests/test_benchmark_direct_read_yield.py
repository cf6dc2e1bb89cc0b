"""The reader of ``corpus.direct_read_yield`` on synthetic runs, beside
``corpus.pad_share``, which has to keep reading 0 where each file's
``corpus.stage`` follows its read."""

import types

import pytest

from benchmark import harness
from syllable_detector_tpu_torch.utils import timing

S = 10**9  # ns a second; the window runs from 100 s to 110 s


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    monkeypatch.setattr(timing, "_RING", timing._Ring(64))


def run():
    return types.SimpleNamespace(window=(100.0, 110.0))


def at(name, a, b, **counts):
    timing.record(name, round(a * S), round(b * S), **counts)


@pytest.mark.parametrize("directs, want", [([1, 1, 1], 1.0), ([1, 0, 1], 2 / 3),
                                           ([None, None, None], None)],
                         ids=["all_direct", "one_falls_back", "no_direct_count"])
def test_direct_read_yield_and_pad_share_beside_the_scan_s_opening_stage(directs, want):
    """``corpus.direct_read_yield`` is Σ``direct`` over the ``corpus.read``
    spans that ended inside the window (None where reads carry no
    ``direct``, as an older program's do); ``corpus.pad_share`` reads 0 with
    the scan's opening stage, which stages nothing, beside the files'."""
    at("corpus.read", 99.0, 99.5, direct=0)  # ended before the window
    at("corpus.stage", 100.5, 100.6, lanes=0, samples=0, staged_samples=0)
    for k, d in enumerate(directs):
        at("corpus.read", 101.0 + k, 101.5 + k, **({} if d is None else {"direct": d}))
        at("corpus.stage", 101.5 + k, 101.6 + k, lanes=2, samples=1000, staged_samples=1000)
    at("corpus.read", 109.5, 110.5, direct=0)  # ends after it
    yield_ = harness.load_module("metrics", "corpus.direct_read_yield").read(run())
    assert yield_ == (None if want is None else pytest.approx(want))
    assert harness.load_module("metrics", "corpus.pad_share").read(run()) == 0.0
    spec = {m["name"]: m for m in harness.benchmark_spec()["per_layer"]}
    assert spec["corpus.direct_read_yield"] == {
        "name": "corpus.direct_read_yield", "unit": "fraction", "better": "higher",
        "source": "program_span", "layer": "corpus read", "moves": "corpus_audio_s_per_s",
        "workloads": ["corpus_sample_mixed"]}
