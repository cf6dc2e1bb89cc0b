"""The whole corpus scan's share of the card's float32 peak: the band
DFT's, the MLP's and the resampler's operations that the window's audio
needs, over the window's wall."""

from benchmark import roofline
from benchmark.readers import traced, corpus_work, percent, wall


def read(run):
    if not traced(run):
        return None
    return percent(corpus_work(run)[2], wall(run) * roofline.PEAK_FP32_FLOPS)
