"""What the per-layer metrics read of the port's own spans: the ring of
``syllable_detector_tpu_torch.utils.timing``, read after the window has
closed, over the window (``run.window``, on the ring's clock:
``perf_counter``).

A program without the ring (an older checkout) has nothing to read, and
every reader here returns None there; so does a window from which the ring
dropped spans, since a reading of what is left would undercount.
"""

from __future__ import annotations

from benchmark.readers import wall


def window_spans(run) -> list | None:
    """The port's spans that overlap the run's window, or None."""
    from syllable_detector_tpu_torch.utils import timing

    if not hasattr(timing, "spans"):
        return None
    lo = round(run.window[0] * 1e9)
    dropped, dropped_end = timing.drops()
    if dropped and dropped_end >= lo:
        return None
    return timing.spans(lo, round(run.window[1] * 1e9))


def share(run, name: str) -> float | None:
    """Share of the window's wall inside the spans ``name`` (their union,
    clipped to the window)."""
    spans = window_spans(run)
    lo, hi = (round(t * 1e9) for t in run.window)
    ivs = sorted((max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans or () if s.name == name)
    if not ivs:
        return None
    total, reach = 0, lo
    for a, b in ivs:
        a = max(a, reach)
        if b > a:
            total, reach = total + b - a, b
    return total / 1e9 / wall(run)


def counts(run, name: str, *keys: str) -> list[int] | None:
    """The sums of ``keys`` over the spans ``name`` that ended inside the
    window (a span's counts are known at its end), or None where none did."""
    spans = window_spans(run)
    hi = round(run.window[1] * 1e9)
    inside = [s for s in spans or () if s.name == name and s.end_ns <= hi]
    if not inside or not all(k in s.counts for s in inside for k in keys):
        return None
    return [sum(s.counts[k] for s in inside) for k in keys]
