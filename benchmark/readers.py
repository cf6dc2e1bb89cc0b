"""What the per-layer metric readers share: window walls, kernel times by
name, and the work a window did, counted from shapes."""

from __future__ import annotations

from benchmark import roofline

K1 = "fused_detector_kernel"
K2 = "framed_gemm"


def traced(run) -> bool:
    """Whether the run holds a device trace with events in it (never on the
    CPU)."""
    return run.device_trace is not None and bool(run.device_trace.events)


def wall(run) -> float:
    return run.window[1] - run.window[0]


def span_share(run, name: str) -> float | None:
    """Share of the window's wall inside the spans ``name``."""
    if name not in run.spans.intervals:
        return None
    return run.spans.total(name, *run.window) / wall(run)


def kernel_s(run, name: str) -> float | None:
    """Device seconds of the operations whose name holds ``name``; None
    without a device trace or where none ran."""
    if run.device_trace is None:
        return None
    s = run.device_trace.kernel_s(lambda n: name in n)
    return s or None


def percent(part: float | None, whole: float | None) -> float | None:
    if part is None or not whole:
        return None
    return 100.0 * part / whole


def idle(run) -> float | None:
    t = run.device_trace
    if t is None or not t.events:
        return None
    return 1.0 - t.busy_s() / (t.t1 - t.t0)


def live_work(run) -> tuple[float, float]:
    """(least K1 seconds, float32 operations) of the evaluations the
    window's rounds made: each lane's real samples, not the padded bucket."""
    geom = run.geom
    t_range, step, w_len = geom["time_range"], roofline.hop(geom), geom["window_length"]
    itemsize = {"int16": 2, "mulaw8": 1}.get(run.params.get("wire"), 4)
    least, flops = 0.0, 0.0
    for counts in run.work["round_counts"]:
        if counts:
            least += roofline.fused_bound(
                geom, [(c + t_range - 2) * step + w_len for c in counts], itemsize, len(counts))
            flops += sum(roofline.detect_flops(geom, c + t_range - 1, c) for c in counts)
    return least, flops


def corpus_work(run) -> tuple[float, float, float]:
    """(least K1 seconds, least K2 seconds, float32 operations) of the
    window's scans: every lane's samples at the net's rate, and every
    resampled channel's framed GEMM."""
    geom, w = run.geom, run.work
    k1 = roofline.fused_bound(geom, w["lane_samples"], 4, 1)
    k2 = sum(roofline.framed_bound(*shape) for shape in w["k2"])
    flops = sum(roofline.detect_flops(geom, roofline.num_frames(n, geom),
                                      max(0, roofline.num_frames(n, geom) - geom["time_range"] + 1))
                for n in w["lane_samples"])
    flops += sum(2.0 * frames * nnz for _, _, nnz, _, frames in w["k2"])
    return k1 * w["scans"], k2 * w["scans"], flops * w["scans"]
