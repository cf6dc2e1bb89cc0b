"""Training's share of the card's float32 peak: the MLP's forward and
backward operations over the rows and steps the window trained, over the
window's wall."""

from benchmark import roofline
from benchmark.readers import traced, percent, wall


def read(run):
    w = run.work
    if not traced(run) or not w.get("steps"):
        return None
    flops = roofline.train_step_flops(run.geom, w["batch"], w["nets"]) * w["steps"]
    return percent(flops, wall(run) * roofline.PEAK_FP32_FLOPS)
