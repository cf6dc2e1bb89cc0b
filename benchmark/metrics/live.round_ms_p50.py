"""The median host time of a live round: the port's own ``Time`` span
"process" around each ``Processor`` round that gave outputs, reset at the
window's start and read at its end."""


def read(run):
    stats = run.work.get("time_stats", {}).get("process")
    return None if not stats else stats["p50_ns"] / 1e6
