"""Share of the window's wall in ``corpus.resample_channels``, which
resamples each file whose rate is not the net's (a benchmark span)."""

from benchmark.readers import span_share


def read(run):
    share = span_share(run, "corpus.resample_channels")
    return share or None
