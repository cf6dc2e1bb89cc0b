"""Named wall-clock timers (reference: SyllableDetector/Time.swift:12-101).

The reference wraps mach_absolute_time with a global named-timer registry and
per-name stat arrays, used by the simulator to log per-hop ingest/process/skip
latencies (ViewControllerSimulator.swift:291-318). This equivalent uses
perf_counter_ns and adds percentile summaries (p50/p99), which matter more on
an accelerator where dispatch latency is the story.
"""

from __future__ import annotations

import threading
import time as _time
from collections import defaultdict

import numpy as np

__all__ = ["Time"]


class Time:
    _timers: dict[str, int] = {}
    _stats: dict[str, list[int]] = defaultdict(list)
    _lock = threading.Lock()

    def __init__(self):
        self._start_ns = 0
        self._elapsed_ns = 0

    def start(self) -> None:
        self._start_ns = _time.perf_counter_ns()

    def stop(self) -> int:
        self._elapsed_ns = _time.perf_counter_ns() - self._start_ns
        return self._elapsed_ns

    @property
    def nanoseconds(self) -> int:
        return self._elapsed_ns

    # -- global named registry (Time.swift:48-100) --------------------------

    @classmethod
    def start_with_name(cls, name: str) -> None:
        with cls._lock:
            cls._timers[name] = _time.perf_counter_ns()

    @classmethod
    def stop_and_save_with_name(cls, name: str) -> int:
        now = _time.perf_counter_ns()
        with cls._lock:
            start = cls._timers.pop(name, None)
            if start is None:
                return 0
            elapsed = now - start
            cls._stats[name].append(elapsed)
            return elapsed

    @classmethod
    def save_with_name(cls, name: str, nanoseconds: int) -> None:
        with cls._lock:
            cls._stats[name].append(nanoseconds)

    @classmethod
    def summaries(cls) -> dict[str, dict[str, float]]:
        with cls._lock:
            out = {}
            for name, values in cls._stats.items():
                a = np.asarray(values, np.float64)
                out[name] = {
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
        with cls._lock:
            cls._timers.clear()
            cls._stats.clear()
