"""The port's framed GEMM (K2) against its plain version and the library
call ``unfold @ g`` on every pair of the resampler's rates, on channels of
1 s, 5 s and 60 s.

For each channel length of ``SECONDS`` and each pair of
``fixtures.RESAMPLE_RATES`` at the resampler's ratio (its default
``max_denominator``), it resamples one channel of seeded noise and times,
with CUDA events, the median of three batches of 20 calls each of the
kernel, its plain version and ``unfold @ g``, beside the bound
(``chip_smoke.framed_bound``) and the launch the kernel took (the band
launch, or the long launch's slot or run form; CTAs, frames a CTA or a
block, column tile and group or quads a warp, row split). One JSON line a
pair and length, the card's name and power limit in each, then one line a
length with the pairs where the kernel is slower than the library call.
On long channels (``60``) it checks the long launch at the high input
rates, where the slot form takes over from the run form.

Run from the root of the repo, on a machine with one CUDA card:

    PYTHONPATH=. python3 scripts/k2_rate_grid.py [SECONDS ...]

It runs on older checkouts of the port too (from the root of that
checkout, ``PYTHONPATH=. python3 /path/to/k2_rate_grid.py``); where that
checkout's ``chip_smoke.py`` cannot name the launch, the line says so.
"""

from __future__ import annotations

import importlib
import json
import sys

import numpy as np
import torch

SECONDS = (1.0, 5.0, 60.0)
# (samples, batch) of each timing
TIMES = (3, 20)


def pair_times(x: np.ndarray, in_rate: float, out_rate: float) -> tuple:
    """(kernel, plain, library ``unfold @ g``) device ms, the bound and the
    launch of K2 resampling ``x`` from ``in_rate`` to ``out_rate`` at the
    resampler's ratio."""
    import chip_smoke
    from syllable_detector_tpu_torch.ops import resample
    from syllable_detector_tpu_torch.ops.stft import hop_length
    from syllable_detector_tpu_torch.utils.measure import event_ms

    fg = importlib.import_module("syllable_detector_tpu_torch.kernels.framed_gemm")
    xin, g, w_len, overlap, blocks, _ = resample.polyphase_framing(
        x, in_rate, out_rate, device="cuda")
    hop = hop_length(w_len, overlap)
    need = (blocks - 1) * hop + w_len
    xpad = torch.cat([xin, xin.new_zeros(max(0, need - xin.numel()))])[:need]
    chip_smoke.held(fg.framed_gemm(xin, g, w_len, overlap, blocks),
                    fg.framed_gemm_reference(xin, g, w_len, overlap, blocks), 1e-4, 1e-4,
                    f"K2 {chip_smoke.rate_name(in_rate, out_rate)}")
    ms = [event_ms(fn, samples=TIMES[0], batch=TIMES[1])[0] for fn in (
        lambda: fg.framed_gemm(xin, g, w_len, overlap, blocks),
        lambda: fg.framed_gemm_reference(xin, g, w_len, overlap, blocks),
        lambda: xpad.unfold(0, w_len, hop) @ g)]
    launch_of = getattr(chip_smoke, "launch_of", None)
    return (*ms, chip_smoke.framed_bound(xin, g, blocks)[0],
            launch_of(xin, g, w_len, overlap, blocks) if launch_of else "not named")


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_rate_grid: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from syllable_detector_tpu_torch import fixtures

    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = chip_smoke.card()
    for seconds in [float(a) for a in sys.argv[1:]] or SECONDS:
        losses = []
        for in_rate in fixtures.RESAMPLE_RATES:
            x = np.random.default_rng(6).uniform(
                -0.7, 0.7, int(seconds * in_rate)).astype(np.float32)
            for out_rate in fixtures.RESAMPLE_RATES:
                if out_rate == in_rate:
                    continue
                kernel, plain, library, least, launch = pair_times(x, in_rate, out_rate)
                name = chip_smoke.rate_name(in_rate, out_rate)
                print(json.dumps({"card": card_line, "seconds": seconds, "pair": name,
                                  "kernel_ms": kernel, "plain_ms": plain, "library_ms": library,
                                  "bound_ms": least, "kernel_over_library": kernel / library,
                                  "launch": launch}), flush=True)
                if kernel > library:
                    losses.append((name, kernel / library, launch))
        losses.sort(key=lambda t: -t[1])
        print(json.dumps({"card": card_line, "seconds": seconds, "slower_than_library": losses}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
