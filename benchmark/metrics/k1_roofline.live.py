"""K1 (``csrc/fused_detector.cu``) on the live rounds: the least time of the
evaluations the window's rounds made (each lane's real samples, not the
padded bucket; ``roofline.fused_bound``) over the kernel's device time."""

from benchmark.readers import K1, kernel_s, live_work, percent


def read(run):
    return percent(live_work(run)[0], kernel_s(run, K1))
