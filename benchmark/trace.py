"""Spans the benchmark installs around the program's functions, and the
device trace of a window.

Spans are host intervals on ``time.perf_counter``, recorded by wrappers this
folder installs around module functions of the port (never by an edit of
the port). The device trace is ``torch.profiler`` with CUDA activity only
(the method of ``chip_smoke.busy_share``, ``chip_smoke.py:2246-2269``: the
union of kernel and copy intervals over the wall, no host-side tracing);
its events carry the system clock, which :class:`DeviceTrace` maps onto
``perf_counter`` so that an idle gap can be named by the span the host was
in.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict


class Spans:
    """Named host intervals, and wrappers that record them."""

    def __init__(self):
        self.intervals: dict[str, list[tuple[float, float]]] = defaultdict(list)

    def total(self, name: str, lo: float = float("-inf"), hi: float = float("inf")) -> float:
        """Seconds of ``name``'s intervals inside [lo, hi]."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.intervals.get(name, ()))

    @contextlib.contextmanager
    def around(self, owner, attr: str, name: str):
        """Inside ``with``: ``owner.attr`` (a function looked up at call
        time) records a span ``name`` for each call."""
        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                self.intervals[name].append((t0, time.perf_counter()))

        setattr(owner, attr, wrapped)
        try:
            yield
        finally:
            setattr(owner, attr, original)

    def at(self, t: float) -> str:
        """The innermost span covering host time ``t`` ("host outside any
        span" where none does)."""
        best, width = "host outside any span", float("inf")
        for name, ivs in self.intervals.items():
            for a, b in ivs:
                if a <= t <= b and b - a < width:
                    best, width = name, b - a
        return best


def short_name(name: str) -> str:
    """A device operation's name without its template and parameter lists."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:120]
    out, depth = [], 0
    for ch in name.removeprefix("void "):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def warm_profiler() -> None:
    """Start and stop the profiler once, so that the tracer's own set-up
    (seconds at its first start in a process) falls in set-up and not in a
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class DeviceTrace:
    """``torch.profiler`` over a window, CUDA activity only. After ``with``:
    ``events`` [(name, start, end)] in host ``perf_counter`` seconds, ``t0``
    and ``t1`` the traced window."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.events, self._prof = [], None
        if torch.cuda.is_available():  # a CPU run has no device to trace
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        # the system clock of the trace against perf_counter
        self._offset = time.time_ns() / 1e9 - time.perf_counter()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self._prof is None:
            self.t1 = time.perf_counter()
            return False
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        results = self._prof.profiler.kineto_results
        self.events = []
        for e in results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            a = e.start_ns() / 1e9 - self._offset
            self.events.append((short_name(e.name()), a, a + e.duration_ns() / 1e9))
        self.events.sort(key=lambda ev: ev[1])
        self._prof = None
        return False

    def busy(self, lo: float | None = None, hi: float | None = None) -> list[tuple[float, float]]:
        """The union of device activity inside [lo, hi] (default: the
        traced window), as disjoint intervals."""
        lo = self.t0 if lo is None else lo
        hi = self.t1 if hi is None else hi
        out: list[list[float]] = []
        for _, a, b in self.events:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, lo=None, hi=None) -> float:
        return sum(b - a for a, b in self.busy(lo, hi))

    def kernel_s(self, match) -> float:
        """Summed seconds of the traced window's device operations whose name
        ``match`` accepts."""
        return sum(b - a for n, a, b in self.events if self.t0 <= a < self.t1 and match(n))

    def breakdown(self, spans: Spans) -> dict:
        """The 10 device operations that took most time (summed by name)
        and the 10 longest idle gaps, each named by the span the host was
        in at the gap's middle."""
        by_name: dict[str, float] = defaultdict(float)
        for n, a, b in self.events:
            by_name[n] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, prev = [], self.t0
        for a, b in self.busy():
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((self.t1 - prev, prev, self.t1))
        gaps.sort(reverse=True)
        return {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[spans.at((a + b) / 2), s] for s, a, b in gaps[:10]],
        }
