"""The reader of ``corpus.read_pieces`` on synthetic runs."""

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


@pytest.mark.parametrize("pieces, want", [([1, 1, 1], 1.0), ([3, 3, 6], 4.0),
                                          ([3, 3, 6, 3, 3, 6, 3, 3], 3.75),
                                          ([None, None, None], None)],
                         ids=["whole_files", "three_cut", "the_corpus_cell_at_4_MiB",
                              "no_pieces_count"])
def test_read_pieces_is_the_mean_over_the_reads_that_ended_in_the_window(pieces, want):
    """``corpus.read_pieces`` is the mean of ``pieces`` over the
    ``corpus.read`` spans that ended inside the window, whatever else the
    window holds; None where the reads carry no ``pieces``, as an older
    program's do."""
    at("corpus.read", 99.0, 99.5, direct=1, inflight=1, pieces=50)  # ended before the window
    at("corpus.stage", 100.5, 100.6, lanes=2, samples=1000, staged_samples=1000)
    for k, n in enumerate(pieces):
        at("corpus.read", 101.0 + k / 2, 101.4 + k / 2,
           **({"direct": 1, "inflight": 1} if n is None
              else {"direct": 1, "inflight": 1, "pieces": n}))
    at("corpus.read", 109.5, 110.5, direct=1, inflight=1, pieces=50)  # ends after it
    got = harness.load_module("metrics", "corpus.read_pieces").read(run())
    assert got == (None if want is None else pytest.approx(want))
    spec = {m["name"]: m for m in harness.benchmark_spec()["per_layer"]}
    assert spec["corpus.read_pieces"] == {
        "name": "corpus.read_pieces", "unit": "pieces", "better": "higher",
        "source": "program_span", "layer": "corpus read", "moves": "corpus_audio_s_per_s",
        "workloads": ["corpus_sample_mixed"]}
