"""Share of the window's wall inside the port's ``corpus.copy_in`` spans: a
scan's staged lanes copied to the card from pageable memory (a span of the
program's own ring)."""

from benchmark.program_spans import share


def read(run):
    return share(run, "corpus.copy_in")
