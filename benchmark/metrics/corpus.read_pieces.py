"""Mean count of the pieces each file's read was cut into: ``pieces`` over
the port's ``corpus.read`` spans that ended inside the window (counts of
the program's own ring). 1 where every file is read in one piece; a program
whose reads carry no ``pieces`` count gives None."""

from benchmark.program_spans import counts, window_spans


def read(run):
    got = counts(run, "corpus.read", "pieces")
    if not got:
        return None
    hi = round(run.window[1] * 1e9)
    reads = sum(s.name == "corpus.read" and s.end_ns <= hi for s in window_spans(run))
    return got[0] / reads
