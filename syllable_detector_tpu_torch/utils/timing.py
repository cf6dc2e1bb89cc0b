"""Named wall-clock timers and the program's spans (reference:
SyllableDetector/Time.swift:12-101).

The reference wraps mach_absolute_time with a global named-timer registry and
per-name stat arrays, used by the simulator to log per-hop ingest/process/skip
latencies (ViewControllerSimulator.swift:291-318). Here every timing is a span
in one bounded ring: its name, its start and end on ``perf_counter_ns`` (the
clock ``time.perf_counter`` reads, onto which a device trace's events can be
mapped), the span it was opened inside (a per-thread stack), its thread and
optional integer counts. The ring keeps the newest :data:`CAPACITY` spans and
counts the ones it drops, so a loop that records every round holds bounded
memory. :class:`Time` keeps the reference's registry on the same ring and adds
percentile summaries (p50/p99), which matter more on an accelerator where
dispatch latency is the story.

Spans sit at call boundaries, never per output row or per optimizer step.
Recording is on from import; :func:`set_recording` turns it off and on.
"""

from __future__ import annotations

import itertools
import threading
from time import perf_counter_ns
from typing import NamedTuple

import numpy as np

__all__ = ["CAPACITY", "SpanRecord", "Time", "drops", "record", "set_recording", "span",
           "spans"]

# spans the ring holds: a 30 s window of the live path's rounds (about 340 a
# second, at most 6 spans each) is 61,200
CAPACITY = 1 << 17


class SpanRecord(NamedTuple):
    """One recorded span. ``id`` numbers spans in the order they opened;
    ``parent`` is the id of the span open around it on its thread (-1:
    none)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    thread: int
    counts: dict


class _Ring:
    """The newest ``capacity`` spans, in the order they ended."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._codes: dict[str, int] = {}
        self._names: list[str] = []
        self._name = np.empty(capacity, np.int32)
        self._cols = np.empty((5, capacity), np.int64)  # start, end, id, parent, thread
        self._counts: dict[int, dict] = {}  # slot -> counts, for spans that have any
        self.written = 0
        self.dropped = 0
        self.dropped_end_ns = -1  # the latest end of a dropped span

    def add(self, name: str, start: int, end: int, sid: int, parent: int,
            counts: dict | None) -> None:
        thread = threading.get_ident()
        with self._lock:
            code = self._codes.get(name)
            if code is None:
                code = self._codes[name] = len(self._names)
                self._names.append(name)
            slot = self.written % self.capacity
            if self.written >= self.capacity:
                self.dropped += 1
                self.dropped_end_ns = max(self.dropped_end_ns, int(self._cols[1, slot]))
                self._counts.pop(slot, None)
            self._name[slot] = code
            self._cols[:, slot] = (start, end, sid, parent, thread)
            if counts:
                self._counts[slot] = dict(counts)
            self.written += 1

    def snapshot(self) -> tuple[list[str], np.ndarray, np.ndarray, list[dict]]:
        """(names, name codes, [5, n] columns, counts) of the held spans,
        oldest first."""
        with self._lock:
            n = min(self.written, self.capacity)
            order = (np.arange(n) + (self.written - n)) % self.capacity
            return (list(self._names), self._name[order], self._cols[:, order],
                    [self._counts.get(int(s), {}) for s in order])

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self.written = self.dropped = 0
            self.dropped_end_ns = -1


_RING = _Ring(CAPACITY)
_ids = itertools.count()
_local = threading.local()
_recording = True


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _top() -> int:
    stack = _stack()
    return stack[-1] if stack else -1


def set_recording(on: bool) -> bool:
    """Record spans (``on``) or not; returns the previous setting."""
    global _recording
    was, _recording = _recording, bool(on)
    return was


class span:
    """``with span(name, **counts) as s:`` records one span around the
    block, inside whichever span its thread has open. Counts known only at
    the end go into ``s.counts``; ``s.name`` may be set before the end."""

    __slots__ = ("name", "counts", "id", "parent", "start_ns")

    def __init__(self, name: str, **counts: int):
        self.name, self.counts, self.id = name, counts, -1

    def __enter__(self) -> "span":
        if _recording:
            stack = _stack()
            self.parent = stack[-1] if stack else -1
            self.id = next(_ids)
            stack.append(self.id)
            self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = perf_counter_ns()
        if self.id >= 0:
            _stack().pop()
            _RING.add(self.name, self.start_ns, end, self.id, self.parent, self.counts)
        return False


def record(name: str, start_ns: int, end_ns: int, **counts: int) -> None:
    """A span whose interval is already known, inside the span its thread
    has open."""
    if _recording:
        _RING.add(name, start_ns, end_ns, next(_ids), _top(), counts)


def spans(lo_ns: int | None = None, hi_ns: int | None = None) -> list[SpanRecord]:
    """The held spans that overlap ``[lo_ns, hi_ns]``, in the order they
    ended."""
    names, codes, cols, counts = _RING.snapshot()
    keep = np.ones(len(codes), bool)
    if lo_ns is not None:
        keep &= cols[1] >= lo_ns
    if hi_ns is not None:
        keep &= cols[0] <= hi_ns
    return [SpanRecord(names[codes[i]], *map(int, cols[:, i]), counts[i])
            for i in np.flatnonzero(keep)]


def drops() -> tuple[int, int]:
    """(spans dropped, the latest end among them in ns, -1 with none): a
    window that starts after that end lost nothing."""
    return _RING.dropped, _RING.dropped_end_ns


class Time:
    """The reference's named-timer registry (Time.swift:48-100): each saved
    timing is a span in the ring, ending when it is saved."""

    _timers: dict[str, tuple[int, int, int]] = {}  # name -> (start, parent, id)
    _lock = threading.Lock()

    @classmethod
    def start_with_name(cls, name: str) -> None:
        with cls._lock:
            cls._timers[name] = (perf_counter_ns(), _top(), next(_ids))

    @classmethod
    def stop_and_save_with_name(cls, name: str) -> int:
        now = perf_counter_ns()
        with cls._lock:
            started = cls._timers.pop(name, None)
        if started is None:
            return 0
        start, parent, sid = started
        if _recording:
            _RING.add(name, start, now, sid, parent, None)
        return now - start

    @classmethod
    def save_with_name(cls, name: str, nanoseconds: int) -> None:
        now = perf_counter_ns()
        record(name, now - nanoseconds, now)

    @classmethod
    def summaries(cls) -> dict[str, dict[str, float]]:
        names, codes, cols, _ = _RING.snapshot()
        durations = cols[1] - cols[0]
        out = {}
        for code in np.unique(codes):
            a = durations[codes == code].astype(np.float64)
            out[names[code]] = {
                "count": int(a.size),
                "mean_ns": float(a.mean()),
                "p50_ns": float(np.percentile(a, 50)),
                "p99_ns": float(np.percentile(a, 99)),
                "max_ns": float(a.max()),
            }
        return out

    @classmethod
    def print_all(cls) -> None:
        for name, s in cls.summaries().items():
            print(
                f"{name}: n={s['count']} mean={s['mean_ns']/1e3:.1f}us "
                f"p50={s['p50_ns']/1e3:.1f}us p99={s['p99_ns']/1e3:.1f}us "
                f"max={s['max_ns']/1e3:.1f}us"
            )

    @classmethod
    def reset(cls) -> None:
        """Forget every timer and every held span."""
        with cls._lock:
            cls._timers.clear()
        _RING.clear()
