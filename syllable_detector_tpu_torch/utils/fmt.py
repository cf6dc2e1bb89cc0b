"""Number formatting matching Swift's shortest-round-trip descriptions.

The reference CLI prints Doubles and Floats with Swift's default
``description`` (shortest decimal that round-trips; reference:
SyllableDetectorCLI/TrackDetector.swift:92-96, e.g.
``0,1593298,36.1292063492063,0.918557``). Python's float repr and NumPy's
float32 str use the same shortest-round-trip (Dragon4/Grisu) rule, so these
helpers delegate to them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fmt_float32", "fmt_double"]


def fmt_float32(v) -> str:
    """Shortest round-trip decimal for a float32 value."""
    return str(np.float32(v))


def fmt_double(v) -> str:
    """Shortest round-trip decimal for a float64 value."""
    return repr(float(v))
