"""Spectrogram scaling: ``linear`` (pass-through), ``db`` (amplitude
decibels, 20*log10(x)) and ``log`` (natural log; the reference's log branch
passes its buffers in the wrong order, so the intended log(x) is used, as
in ``syllable_detector_tpu.ops.scaling``)."""

from __future__ import annotations

import torch

__all__ = ["apply_scaling"]


def apply_scaling(x: torch.Tensor, scaling: str) -> torch.Tensor:
    if scaling == "linear":
        return x
    if scaling == "db":
        return 20.0 * torch.log10(x)
    if scaling == "log":
        return torch.log(x)
    raise ValueError(f"unknown scaling {scaling!r}")
