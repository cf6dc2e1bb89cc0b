"""1 - the union of device activity over the traced window (``torch.profiler``)."""

from benchmark.readers import idle


def read(run):
    return idle(run)
