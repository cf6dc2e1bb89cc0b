"""Each traffic kind's cell cut to a size a CPU test run holds."""

from benchmark import harness

SMALL = {
    "live_sample_16ch": dict(lanes=3, loop_hops=40, preroll_s=0.2),
    "corpus_sample_mixed": dict(files=3, file_seconds=2.0),
    "train_sample_defaults": dict(audio_seconds=3.0, epochs=3, warm_epochs=1),
}
SECONDS = {"live_sample_16ch": 0.6, "corpus_sample_mixed": 0.2,
           "train_sample_defaults": 0.2}


def workload(cell: str) -> dict:
    wl = harness.load_json("workloads", cell)
    wl["traffic_params"].update(SMALL[cell])
    return wl
