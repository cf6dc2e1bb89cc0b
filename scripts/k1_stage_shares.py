"""Where the port's fused detector kernel (K1) spends its cycles, in each
shared-memory layout that fits, at the wide geometries.

For each geometry of ``GEOMETRIES`` (from ``fixtures.wide_geometry_configs``)
and each entry (K1a: one 60 s stream; K1e: 256 lanes x 128 evaluations, one
shared net), it launches the kernel once for each frames choice and layout
that fits in shared memory (the most chunks of C a pass), and the launch
``cta_choice`` makes, times it with CUDA events and reads its ``clock64()``
stage shares (``fused.stage_shares``).
One JSON line a launch, the card's name and power limit in each. Then, at
``WIRE_GEOMETRIES``, the streamed layout on each wire (:func:`wire_shares`):
K1f on 256 lanes x 128 evaluations of int16 and of mu-law samples, and K1e on
the samples the int16 wire dequantises to, all three on K1f's launch.

It uses only what the port's kernel wrapper has had since its streamed
layout came in, so it runs on any checkout of the port from then on: run it
from the root of that checkout, on a machine with one CUDA card,

    PYTHONPATH=. python3 path/to/k1_stage_shares.py [NAME ...]

with names of ``fixtures.wide_geometry_configs`` (default
``GEOMETRIES``). ``chip_smoke.py`` phase 22 calls :func:`layout_shares`
on ``GEOMETRIES``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

GEOMETRIES = ("fft1024 overlap900", "96k fft1024", "hidden128")
WIRE_GEOMETRIES = ("96k fft1024", "fft512 hidden16")
LIVE_LANES = 256
LIVE_EVALS = 128
# (samples, batch) of each timing, as chip_smoke.py's geometry times
TIMES = (3, 5)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def layouts_that_fit(fused, spec, width: int) -> list[tuple[int, int, str]]:
    """(frames, col_group, layout) of each frames choice and layout that
    fits: resident, and each layout that streams C (``fused.LAYOUT_LAUNCHES``
    names them) over the most chunks a pass that fit. A layout that keeps
    the span resident takes its chunk count negated."""
    chunks = fused._dft_chunks(spec)
    out = []
    for frames in fused._frame_choices(spec):
        def fits(group):
            return fused.smem_bytes(spec, frames, width, None, False, group) <= fused.SMEM_LIMIT

        if fits(0):
            out.append((frames, 0, "resident"))
        for layout, sign in (("span", -1), ("streamed", 1)):
            if layout not in fused.LAYOUT_LAUNCHES:
                continue
            group = next((g for g in range(chunks, 0, -1) if fits(sign * g)), None)
            if group is not None:
                out.append((frames, sign * group, layout))
    return out


def layout_shares(name: str, cfg, card_line: str) -> list[dict]:
    """One row a launch of K1a and K1e at geometry ``name`` (config
    ``cfg``) in each layout that fits: device ms and stage shares."""
    from syllable_detector_tpu_torch import fixtures
    from syllable_detector_tpu_torch.kernels import fused_detector as fused
    from syllable_detector_tpu_torch.models import detector
    from syllable_detector_tpu_torch.ops.stft import normalize_overlap, num_frames
    from syllable_detector_tpu_torch.utils.measure import event_ms

    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    folded = fused.fold_constants(spec, params, "cuda")
    width = max(w for _, w in spec.net.layer_sizes)
    stream = torch.from_numpy(fixtures.chirp_audio(60.0, 23, rate=int(cfg.sampling_rate))).cuda()
    gap, _ = normalize_overlap(spec.window_overlap)
    n_live = (LIVE_EVALS + spec.time_range - 2) * spec.hop + gap + spec.window_length
    rng = np.random.default_rng(8)
    live = torch.from_numpy(
        rng.uniform(-0.7, 0.7, (LIVE_LANES, n_live)).astype(np.float32)).cuda()
    rows = []
    for entry, xs in (("K1a", stream[None]), ("K1e", live)):
        n_evals = num_frames(xs.shape[1], spec.window_length, spec.window_overlap) - spec.time_range + 1
        chosen = fused.cta_choice(spec, n_evals, xs.shape[0], width)
        launches = layouts_that_fit(fused, spec, width)
        if tuple(chosen) not in [(f, g) for f, g, _ in launches]:
            launches.append((*chosen, chosen.layout))
        for frames, group, layout in launches:
            def launch(frames=frames, group=group):
                fused._launch(spec, folded, xs, n_evals, frames=frames, col_group=group)

            ms = event_ms(launch, samples=TIMES[0], batch=TIMES[1])[0]
            shares = fused.stage_shares(launch)
            rows.append({
                "card": card_line, "geometry": name, "entry": entry, "frames": frames,
                "col_group": group, "layout": layout,
                "chosen": tuple(chosen) == (frames, group), "ms": ms,
                "shares": {k: round(v, 4) for k, v in shares.items()},
            })
    return rows


def wire_shares(name: str, cfg, card_line: str) -> list[dict]:
    """One row a wire at geometry ``name``: device ms and stage shares of
    one launch on 256 lanes x 128 evaluations with a net per lane, at the
    launch K1f takes on the int16 wire: int16 and mu-law samples (K1f), and
    the float32 samples the int16 wire dequantises to (K1e)."""
    from syllable_detector_tpu_torch.kernels import fused_detector as fused
    from syllable_detector_tpu_torch.models import detector
    from syllable_detector_tpu_torch.ops.stft import normalize_overlap
    from syllable_detector_tpu_torch.utils.measure import event_ms

    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    folded = fused.fold_constants_stacked(spec, [params] * LIVE_LANES, "cuda")
    width = max(w for _, w in spec.net.layer_sizes)
    gap, _ = normalize_overlap(spec.window_overlap)
    n_live = (LIVE_EVALS + spec.time_range - 2) * spec.hop + gap + spec.window_length
    rng = np.random.default_rng(8)
    live = rng.uniform(-0.7, 0.7, (LIVE_LANES, n_live)).astype(np.float32)
    q = np.rint(np.clip(live, -1.0, 1.0) * 32767.0).astype(np.int16)
    # the bank's mu-law staging: encode, then round to 8 bits
    y = np.clip(live, -1.0, 1.0)
    mu = np.sign(y) * np.log1p(255.0 * np.abs(y)) / np.log1p(255.0)
    wires = {"int16": torch.from_numpy(q).cuda(),
             "mulaw8": torch.from_numpy(np.rint(mu * 127.0).astype(np.int8)).cuda()}
    wires["float32"] = fused.dequant(wires["int16"], "int16").contiguous()
    chosen = fused.cta_choice(spec, LIVE_EVALS, LIVE_LANES, width)
    rows = []
    for wire, xs in wires.items():
        def launch(wire=wire, xs=xs):
            fused._launch(spec, folded, xs, LIVE_EVALS, wire=wire, frames=chosen[0],
                          col_group=chosen[1])

        ms = event_ms(launch, samples=TIMES[0], batch=TIMES[1])[0]
        shares = fused.stage_shares(launch)
        rows.append({
            "card": card_line, "geometry": name, "entry": "K1e" if wire == "float32" else "K1f",
            "wire": wire, "frames": chosen[0], "col_group": chosen[1], "ms": ms,
            "shares": {k: round(v, 4) for k, v in shares.items()},
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_stage_shares: no CUDA device is available", file=sys.stderr)
        return 1
    from syllable_detector_tpu_torch import fixtures

    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = card()
    configs = dict(fixtures.wide_geometry_configs())
    for name in sys.argv[1:] or GEOMETRIES:
        for row in layout_shares(name, configs[name], card_line):
            print(json.dumps(row), flush=True)
    for name in sys.argv[1:] or WIRE_GEOMETRIES:
        for row in wire_shares(name, configs[name], card_line):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
