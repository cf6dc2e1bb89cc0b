"""K1 (``csrc/fused_detector.cu``) in the corpus scans: the least time of
every lane's real samples at the net's rate (not the power-of-two bucket)
over the kernel's device time."""

from benchmark.readers import K1, corpus_work, kernel_s, percent


def read(run):
    return percent(corpus_work(run)[0], kernel_s(run, K1))
