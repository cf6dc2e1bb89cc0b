"""Inspect a network file: the human-readable summary the reference GUI shows
when loading a network per channel (ViewControllerProcessor.swift:222-276),
plus derived detection geometry.

Counterpart of ``syllable_detector_tpu.inspect_net``, with the same text. It
reads shapes only, so it runs on the CPU and needs no card.

Usage: python -m syllable_detector_tpu_torch inspect -n NET.txt
"""

from __future__ import annotations

import argparse
import sys

from syllable_detector_tpu_torch.config.model_format import ConfigError, load_config
from syllable_detector_tpu_torch.models.detector import detector_spec_from_config

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="syllable-detector-torch-inspect")
    p.add_argument("-n", "--net", required=True, help="Network file.")
    args = p.parse_args(argv)

    try:
        cfg = load_config(args.net)
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1

    try:
        spec, _ = detector_spec_from_config(cfg, "cpu")
        bins = spec.bins
    except ValueError as e:
        print(f"Invalid configuration: {e}", file=sys.stderr)
        return 1

    rate = cfg.sampling_rate
    print(f"network:            {args.net}")
    print(f"sampling rate:      {rate:g} Hz")
    print(f"fft / window:       {cfg.fourier_length} / {cfg.window_length}")
    overlap_desc = (
        f"{cfg.window_overlap} (gap {cfg.gap})" if cfg.window_overlap < 0
        else str(cfg.window_overlap)
    )
    print(f"overlap:            {overlap_desc}")
    print(f"hop:                {cfg.hop} samples = {cfg.hop/rate*1e3:.2f} ms")
    print(
        f"frequency band:     {cfg.freq_range[0]:g}-{cfg.freq_range[1]:g} Hz "
        f"-> bins [{bins[0]}, {bins[1]}) = {bins[1]-bins[0]} bins"
    )
    print(f"time range:         {cfg.time_range} frames")
    print(
        f"first decision:     sample {cfg.first_output_sample} = "
        f"{cfg.first_output_sample/rate*1e3:.1f} ms"
    )
    print(f"scaling:            {cfg.scaling}")
    print(
        "input processing:   "
        + (" -> ".join(p_.name for p_ in cfg.process_inputs) or "none")
    )
    arch = " -> ".join(
        f"{l.inputs}x{l.outputs} {l.transfer}" for l in cfg.layers
    )
    print(f"layers:             {arch}")
    print(
        "output processing:  "
        + (" -> ".join(p_.name for p_ in cfg.process_outputs) or "none")
    )
    print(f"thresholds:         {', '.join(f'{t:g}' for t in cfg.thresholds)}")
    n_params = sum(l.weights.size + l.biases.size for l in cfg.layers)
    print(f"parameters:         {n_params}")
    from syllable_detector_tpu_torch.kernels.fused_detector import fusable

    print(f"fused-kernel ready: {fusable(spec)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
