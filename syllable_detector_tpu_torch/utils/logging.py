"""Debug logging (reference: Common/Common.swift:10-14).

The reference's DLog compiles to a no-op outside DEBUG builds; here dlog is
gated on the SYLLABLE_DETECTOR_DEBUG env var (or logging config) and writes
to stderr with the caller's location, like DLog's function/line prefix.
"""

from __future__ import annotations

import inspect
import os
import sys

__all__ = ["dlog", "debug_enabled"]


def debug_enabled() -> bool:
    return os.environ.get("SYLLABLE_DETECTOR_DEBUG", "") not in ("", "0", "false")


def dlog(message: str) -> None:
    if not debug_enabled():
        return
    frame = inspect.currentframe()
    caller = frame.f_back if frame is not None else None
    if caller is not None:
        loc = f"{os.path.basename(caller.f_code.co_filename)}:{caller.f_lineno}"
    else:
        loc = "?"
    print(f"[{loc}] {message}", file=sys.stderr)
