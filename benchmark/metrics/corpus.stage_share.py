"""Share of the window's wall inside the port's ``corpus.stage`` spans: the
zero-filled ``[lanes, bucket]`` array of a scan and its fill (a span of the
program's own ring)."""

from benchmark.program_spans import share


def read(run):
    return share(run, "corpus.stage")
