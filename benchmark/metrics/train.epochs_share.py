"""Share of the window's wall inside the trainer's entry (``train`` as the
train CLI calls it: the chain fit, the epochs, the choice of init), against
the CLI's reading, features and export around it (a benchmark span)."""

from benchmark.readers import span_share


def read(run):
    return span_share(run, "train.trainer")
