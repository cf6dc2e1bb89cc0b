"""How late the paced source delivered the window's blocks against their
schedule, 95th percentile (the capture layer's share of a hop's latency)."""

import numpy as np


def read(run):
    late = run.work.get("feed_late_ms")
    return None if late is None or not len(late) else float(np.percentile(late, 95))
