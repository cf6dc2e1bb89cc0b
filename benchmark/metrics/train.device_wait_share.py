"""Share of the window's wall inside the port's ``trainer.device_wait`` spans:
the host waiting for the epochs it enqueued before the full-data loss (a
span of the program's own ring; the window holds the plain runs only)."""

from benchmark.program_spans import share


def read(run):
    return share(run, "trainer.device_wait")
