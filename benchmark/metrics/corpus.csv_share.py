"""Share of the window's wall in ``corpus.corpus_csv_lines`` (a span the
benchmark installs around the module function)."""

from benchmark.readers import span_share


def read(run):
    return span_share(run, "corpus.corpus_csv_lines")
