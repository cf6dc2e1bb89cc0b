"""Share of the window's wall inside the port's ``train.features`` spans: the
train CLI's ``features_and_labels`` (a span of the program's own ring; the
window holds the plain runs only)."""

from benchmark.program_spans import share


def read(run):
    return share(run, "train.features")
