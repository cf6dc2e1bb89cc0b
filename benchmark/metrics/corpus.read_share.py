"""Share of the window's wall inside the port's ``corpus.read`` spans: each
file's ``read_audio`` and its decode (a span of the program's own ring)."""

from benchmark.program_spans import share


def read(run):
    return share(run, "corpus.read")
