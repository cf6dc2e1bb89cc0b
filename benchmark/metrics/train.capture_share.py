"""Share of the window's wall inside the port's ``trainer.capture`` spans: each
run's warm steps and the capture of its epoch graph (a span of the program's
own ring; the window holds the plain runs only)."""

from benchmark.program_spans import share


def read(run):
    return share(run, "trainer.capture")
