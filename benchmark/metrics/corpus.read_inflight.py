"""Mean count of the reads of a scan in flight as each file's read started,
itself included: ``inflight`` over the port's ``corpus.read`` spans that
ended inside the window (counts of the program's own ring). 1 where a scan
reads its files one after another; a program whose reads carry no
``inflight`` count gives None."""

from benchmark.program_spans import counts, window_spans


def read(run):
    got = counts(run, "corpus.read", "inflight")
    if not got:
        return None
    hi = round(run.window[1] * 1e9)
    reads = sum(s.name == "corpus.read" and s.end_ns <= hi for s in window_spans(run))
    return got[0] / reads
