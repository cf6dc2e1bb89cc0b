"""The measurements behind two choices of the port's fused detector kernel
(K1) wrapper, ``syllable_detector_tpu_torch/kernels/fused_detector.py``.

``first-layer``: K1a on one 60 s stream and K1e on 256 lanes x 128
evaluations at the sample geometry, with first layers of ``WIDTHS`` hidden
units, the fp32 first layer forced onto the CUDA cores and onto the tensor
cores, each held against its plain version (1e-3/2e-4): the times that set
``TC_FIRST_LAYER_COLS``.

``layouts``: on every fusable geometry of fuzz seeds ``SEEDS`` and
``fixtures.wide_geometry_configs()``, for every tier and input form, at
one 60 s stream and (from samples) at 256 lanes x 128 evaluations, where
the resident layout does not fit: the span layout at each frames choice
it fits (a round's chunks of C a pass, or fewer where they do not fit)
against the launch ``cta_choice`` takes without the span layout
(``layouts=("resident", "streamed")``), the outputs equal bit for bit,
and which of them ``cta_choice`` takes.

One JSON line a measurement, the card's name and power limit in each.
Run from the root of the repo, on a machine with one CUDA card:

    PYTHONPATH=. python3 scripts/k1_choices.py [first-layer] [layouts]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

WIDTHS = (4, 8, 16, 24, 32, 64, 128)
SEEDS = range(1000, 1100)
LIVE_LANES = 256
LIVE_EVALS = 128
# (samples, batch) of each timing
TIMES = (3, 5)


def first_layer(card_line: str) -> None:
    import chip_smoke
    from syllable_detector_tpu_torch import fixtures
    from syllable_detector_tpu_torch.kernels import fused_detector as fused
    from syllable_detector_tpu_torch.models import detector
    from syllable_detector_tpu_torch.ops.stft import num_frames
    from syllable_detector_tpu_torch.utils.measure import event_ms

    x = torch.from_numpy(fixtures.chirp_audio(60.0, 23)).cuda()
    for h1 in WIDTHS:
        spec, params = detector.detector_spec_from_config(
            fixtures.geometry_config(7, hidden=(h1,)), "cuda")
        folded = fused.fold_constants(spec, params, "cuda")
        # the tensor cores' bank tiled once, as the fold tiles it for a wide net
        folded = folded._replace(w1g_tf32=fused.tile_conv_bank_tf32(folded.w1))
        live = torch.from_numpy(np.random.default_rng(8).uniform(
            -0.7, 0.7, (LIVE_LANES, chip_smoke.bucket_samples(spec, LIVE_EVALS))
        ).astype(np.float32)).cuda()
        for entry, xs in (("K1a", x[None]), ("K1e", live)):
            n_evals = num_frames(xs.shape[1], spec.window_length, spec.window_overlap) \
                - spec.time_range + 1
            plain = fused.fused_batch_outputs_reference(spec, folded, xs, n_evals=n_evals)
            for tc in (False, True):
                def launch(tc=tc, xs=xs, n_evals=n_evals):
                    return fused._launch(spec, folded, xs, n_evals, tc=tc)

                chip_smoke.held(launch(), plain, 1e-3, 2e-4, f"hidden {h1} {entry} tc {tc}")
                ms = event_ms(launch, samples=TIMES[0], batch=TIMES[1])[0]
                print(json.dumps({"card": card_line, "measure": "first-layer",
                                  "cols": spec.time_range * h1, "entry": entry,
                                  "cores": "tensor" if tc else "CUDA", "ms": ms}), flush=True)


def layouts(card_line: str) -> None:
    import chip_smoke
    from syllable_detector_tpu_torch import fixtures
    from syllable_detector_tpu_torch.kernels import fused_detector as fused
    from syllable_detector_tpu_torch.models import detector
    from syllable_detector_tpu_torch.ops.stft import frame_signal, num_frames
    from syllable_detector_tpu_torch.utils.measure import event_ms

    geometries = [(f"fuzz{seed}", fixtures.random_config(np.random.default_rng(seed)))
                  for seed in SEEDS] + list(fixtures.wide_geometry_configs())
    forms = [(None, False), (None, True)] + [(tier, False) for tier in fused.TIERS]
    for name, cfg in geometries:
        spec, params = detector.detector_spec_from_config(cfg, "cpu")
        if not fused.fusable(spec):
            continue
        width = max(w for _, w in spec.net.layer_sizes)
        stream = fixtures.chirp_audio(60.0, 23, rate=int(cfg.sampling_rate))
        stream_evals = num_frames(stream.size, spec.window_length, spec.window_overlap) \
            - spec.time_range + 1
        shapes = {"K1a": (1, stream_evals), "K1e": (LIVE_LANES, LIVE_EVALS)}

        def span_group(f, tier, frames_input):
            return next((-g for g in range(fused.round_chunks(spec, f), 0, -1)
                         if fused.smem_bytes(spec, f, width, tier, frames_input, -g)
                         <= fused.SMEM_LIMIT), None)

        wanted = []
        for tier, frames_input in forms:
            choices = fused._frame_choices(spec)
            if any(fused.smem_bytes(spec, f, width, tier, frames_input) <= fused.SMEM_LIMIT
                   for f in choices):
                continue
            spans = [(f, span_group(f, tier, frames_input)) for f in choices]
            spans = [(f, g) for f, g in spans if g is not None]
            wanted += [(entry, tier, frames_input, spans) for entry in shapes
                       if spans and not (frames_input and entry == "K1e")]
        if not wanted:
            continue
        spec, params = detector.detector_spec_from_config(cfg, "cuda")
        folded = fused.fold_constants(spec, params, "cuda")
        x = torch.from_numpy(stream).cuda()
        live = torch.from_numpy(np.random.default_rng(8).uniform(
            -0.7, 0.7, (LIVE_LANES, chip_smoke.bucket_samples(spec, LIVE_EVALS))
        ).astype(np.float32)).cuda()
        for entry, tier, frames_input, spans in wanted:
            xs = x[None] if entry == "K1a" else live
            n_evals = num_frames(xs.shape[1], spec.window_length, spec.window_overlap) \
                - spec.time_range + 1
            if frames_input:
                xs = frame_signal(x, n_evals + spec.time_range - 1, spec.window_length,
                                  spec.window_overlap).contiguous()[None]
            without = fused.cta_choice(spec, n_evals, xs.shape[0], width, tier=tier,
                                       frames_input=frames_input,
                                       layouts=("resident", "streamed"))
            chosen = fused.cta_choice(spec, n_evals, xs.shape[0], width, tier=tier,
                                      frames_input=frames_input)

            def launch(frames, group):
                return fused._launch(spec, folded, xs, n_evals, tier=tier,
                                     frames_input=frames_input, frames=frames, col_group=group)

            base = launch(*without)
            without_ms = event_ms(lambda: launch(*without), samples=TIMES[0], batch=TIMES[1])[0]
            for frames, group in spans:
                chip_smoke.held(launch(frames, group), base, 0.0, 0.0,
                                f"{name} {entry} {tier} span {frames} frames")
                ms = event_ms(lambda f=frames, g=group: launch(f, g), samples=TIMES[0],
                            batch=TIMES[1])[0]
                print(json.dumps({
                    "card": card_line, "measure": "layouts", "geometry": name, "entry": entry,
                    "tier": tier or "fp32", "frames_input": frames_input,
                    "span": [frames, group, ms], "without": [*without, without_ms],
                    "span_over_without": ms / without_ms, "chosen": list(chosen)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_choices: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = chip_smoke.card()
    for what in sys.argv[1:] or ("first-layer", "layouts"):
        {"first-layer": first_layer, "layouts": layouts}[what](card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
