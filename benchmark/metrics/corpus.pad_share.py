"""Share of the samples the window's scans staged and copied that are padding:
1 - the real samples over the staged ``lanes * bucket``, summed over the
port's ``corpus.stage`` spans (counts of the program's own ring)."""

from benchmark.program_spans import counts


def read(run):
    got = counts(run, "corpus.stage", "samples", "staged_samples")
    return None if not got or not got[1] else 1.0 - got[0] / got[1]
