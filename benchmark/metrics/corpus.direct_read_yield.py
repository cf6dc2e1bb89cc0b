"""Share of the files the window's scans read whose 16-bit PCM codes went
straight into the host buffer: Σ``direct`` over the count of the port's
``corpus.read`` spans that ended inside the window (counts of the program's
own ring). A program whose reads carry no ``direct`` count gives None."""

from benchmark.program_spans import counts, window_spans


def read(run):
    got = counts(run, "corpus.read", "direct")
    if not got:
        return None
    hi = round(run.window[1] * 1e9)
    reads = sum(s.name == "corpus.read" and s.end_ns <= hi for s in window_spans(run))
    return got[0] / reads
