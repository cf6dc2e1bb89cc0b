"""CSV lines emitted per output row the CSV loop walks: the lines over the rows
summed over the port's ``corpus.csv`` spans (counts of the program's own
ring)."""

from benchmark.program_spans import counts


def read(run):
    got = counts(run, "corpus.csv", "lines", "rows")
    return None if not got or not got[1] else got[0] / got[1]
