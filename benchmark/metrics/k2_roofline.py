"""K2 (``csrc/framed_gemm.cu``, the resampler's framed GEMM) in the corpus
scans: the least time of every resampled channel (``roofline.framed_bound``)
over the kernel's device time."""

from benchmark.readers import K2, corpus_work, kernel_s, percent


def read(run):
    return percent(corpus_work(run)[1], kernel_s(run, K2))
