"""Thread-safe summary statistics (reference: SyllableDetector/SummaryStat.swift:11-87).

The reference serializes appends/reads through a private GCD queue; here a
lock guards the same append / read-and-reset contract. These feed the monitor
UI's per-channel level meters exactly like the reference's input-RMS and
max-output columns (Processor.swift:69-76, 111-113, 138).
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["Stat", "StatMean", "StatMax", "SummaryStat"]


class Stat:
    def append(self, value: float) -> None:
        raise NotImplementedError

    def read_and_reset(self) -> Optional[float]:
        raise NotImplementedError


class StatMean(Stat):
    """Running mean (SummaryStat.swift:18-37)."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def append(self, value: float) -> None:
        self._sum += value
        self._count += 1

    def read_and_reset(self) -> Optional[float]:
        if self._count == 0:
            return None
        v = self._sum / self._count
        self._sum = 0.0
        self._count = 0
        return v


class StatMax(Stat):
    """Running max (SummaryStat.swift:39-61)."""

    def __init__(self):
        self._max: Optional[float] = None

    def append(self, value: float) -> None:
        if self._max is None or value > self._max:
            self._max = value

    def read_and_reset(self) -> Optional[float]:
        v = self._max
        self._max = None
        return v


class SummaryStat:
    """Serialized wrapper (SummaryStat.swift:63-87)."""

    def __init__(self, stat: Stat):
        self._stat = stat
        self._lock = threading.Lock()

    def write_value(self, value: float) -> None:
        with self._lock:
            self._stat.append(value)

    def read_stat_and_reset(self) -> Optional[float]:
        with self._lock:
            return self._stat.read_and_reset()
