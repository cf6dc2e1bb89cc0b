"""Share of the window's wall inside the port's ``trainer.indices`` spans: the
host's draws of the batch order, their concatenation and upload (a span of the
program's own ring; the window holds the plain runs only)."""

from benchmark.program_spans import share


def read(run):
    return share(run, "trainer.indices")
