"""The measurements behind the framed GEMM kernel's (K2) choice of launch,
``syllable_detector_tpu_torch/kernels/framed_gemm.py`` (``tiling``,
``slot_tiling``).

For each channel length of ``SECONDS`` and each ordered pair of
``fixtures.RESAMPLE_RATES`` at the resampler's ratio (and 192k -> 11.025k
at the exact one) whose long launch can take the slot form, it resamples
one channel of seeded noise and times, with CUDA events, every launch the
wrapper could take: the band launch, the run form (the long launch before
the slot form, ``fpt`` 8 or 4), and the slot form at each frames a lane
(4, 2, 1) and row split (1, 2, 4, 8) that fits, each held against the plain
version (1e-4/1e-4), beside ``unfold @ g`` and the launch ``tiling`` takes. The
slot form without a row split must equal the run form without one bit for
bit (up to the sign of a zero): both sum the same rows in the same order.

One JSON line a pair and length, the card's name and power limit in each.
Run from the root of the repo, on a machine with one CUDA card:

    PYTHONPATH=. python3 scripts/k2_choices.py [SECONDS ...]
"""

from __future__ import annotations

import importlib
import json
import sys

import numpy as np
import torch

SECONDS = (5.0, 60.0)
# (samples, batch) of each timing
TIMES = (3, 20)


def launches(fg, window: int, m: int, hop: int, n_frames: int, ranges) -> dict:
    """Every launch the wrapper could take for this product, by name."""
    out = {"band": fg.band_tiling(window, m, hop, n_frames, None, ranges)}
    for fpt in (fg.FRAMES_PER_THREAD, fg.NARROW_FRAMES):
        cut = fg._tiling(window, m, hop, fpt)
        if cut is not None:
            out["run"] = cut
            break
    for fpt in fg.SLOT_FRAMES:
        for ksplit in (1, 2, 4, 8):
            cut = fg.slot_tiling(window, m, hop, fpt=fpt, ksplit=ksplit)
            if cut is not None:
                out[f"slots fpt{fpt} ksplit{ksplit}"] = cut
    return {name: cut for name, cut in out.items() if cut is not None}


def unsplit(fg, cut):
    """``cut`` without its row split: one warp a unit (a group of quads)."""
    if cut.ksplit == 1:
        return cut
    units = cut.threads // 32 // cut.ksplit
    return cut._replace(ksplit=1, threads=32 * units)


def pair_line(x: np.ndarray, in_rate: float, out_rate: float, denominator: int,
              card_line: str, seconds: float) -> dict | None:
    import chip_smoke
    from syllable_detector_tpu_torch.ops import resample
    from syllable_detector_tpu_torch.ops.stft import hop_length
    from syllable_detector_tpu_torch.utils.measure import event_ms

    fg = importlib.import_module("syllable_detector_tpu_torch.kernels.framed_gemm")
    xin, g, w_len, overlap, blocks, _ = resample.polyphase_framing(
        x, in_rate, out_rate, max_denominator=denominator, device="cuda")
    hop = hop_length(w_len, overlap)
    m = g.shape[1]
    if fg.slot_tiling(w_len, m, hop) is None:
        return None
    _, cg = fg._column_group(m)
    ranges = fg._bands_of(g, cg)[3]
    name = chip_smoke.rate_name(in_rate, out_rate) + ("" if denominator == 1000 else " exact")
    plain = fg.framed_gemm_reference(xin, g, w_len, overlap, blocks)
    need = (blocks - 1) * hop + w_len
    xpad = torch.cat([xin, xin.new_zeros(max(0, need - xin.numel()))])[:need]
    line = {"card": card_line, "seconds": seconds, "pair": name, "window": w_len, "m": m,
            "hop": hop, "frames": blocks,
            "library_ms": event_ms(lambda: xpad.unfold(0, w_len, hop) @ g,
                                   samples=TIMES[0], batch=TIMES[1])[0],
            "plain_ms": event_ms(lambda: fg.framed_gemm_reference(xin, g, w_len, overlap, blocks),
                                 samples=TIMES[0], batch=TIMES[1])[0],
            "bound_ms": chip_smoke.framed_bound(xin, g, blocks)[0],
            "taken": chip_smoke.launch_of(xin, g, w_len, overlap, blocks)}
    for label, cut in launches(fg, w_len, m, hop, blocks, ranges).items():
        got = fg._launch(xin, g, w_len, overlap, blocks, cut)
        chip_smoke.held(got, plain, 1e-4, 1e-4, f"K2 {name} {label}")
        ms = event_ms(lambda: fg._launch(xin, g, w_len, overlap, blocks, cut),
                      samples=TIMES[0], batch=TIMES[1])[0]
        line[label] = {"ms": ms, "ctas": fg.launch_ctas(cut, blocks, fg._sm_count(xin.device)),
                       "frames": cut.frames, "threads": cut.threads, "ksplit": cut.ksplit}
    # the slot form and the run form without a row split sum the same rows
    # in the same order
    slot = unsplit(fg, fg.slot_tiling(w_len, m, hop))
    run = unsplit(fg, launches(fg, w_len, m, hop, blocks, ranges)["run"])
    a = fg._launch(xin, g, w_len, overlap, blocks, slot)
    b = fg._launch(xin, g, w_len, overlap, blocks, run)
    if not torch.equal(a, b):
        raise AssertionError(f"K2 {name}: slots and run without a row split differ by "
                             f"{float((a - b).abs().max())}")
    line["slots equal run bit for bit"] = True
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_choices: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from syllable_detector_tpu_torch import fixtures

    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = chip_smoke.card()
    for seconds in [float(a) for a in sys.argv[1:]] or SECONDS:
        for in_rate in fixtures.RESAMPLE_RATES:
            x = np.random.default_rng(6).uniform(
                -0.7, 0.7, int(seconds * in_rate)).astype(np.float32)
            for out_rate in fixtures.RESAMPLE_RATES:
                cases = [1000] + ([10**6] if (in_rate, out_rate) == (192000, 11025) else [])
                for denominator in cases if out_rate != in_rate else ():
                    line = pair_line(x, in_rate, out_rate, denominator, card_line, seconds)
                    if line is not None:
                        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
