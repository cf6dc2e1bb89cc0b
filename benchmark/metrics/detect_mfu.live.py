"""The whole live detection's share of the card's float32 peak: the band
DFT's and the MLP's operations of the evaluations the window made, over
the window's wall."""

from benchmark import roofline
from benchmark.readers import traced, live_work, percent, wall


def read(run):
    if not traced(run):
        return None
    return percent(live_work(run)[1], wall(run) * roofline.PEAK_FP32_FLOPS)
