"""Input/output processing chains (the MATLAB mapminmax/mapstd family).

Counterpart of ``syllable_detector_tpu.ops.processing``, batched over
leading axes. The input chain is applied in declaration order before the
first layer; each output function's *reverse* mapping is applied after the
last layer, mapping the net's output range back to the target range.

Functions are keyed by name with a parameter dict, laid out as the JAX
package lays out its pytree leaves.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import ProcessingSpec

__all__ = [
    "fold_input_affines",
    "fold_output_affines",
    "apply_named",
    "reverse_named",
    "apply_input_chain",
    "reverse_output_chain",
    "specs_to_chain",
]

Params = Mapping[str, Any]


def apply_named(x: torch.Tensor, name: str, params: Params) -> torch.Tensor:
    """Apply one input-processing function along the last axis."""
    if name in ("mapminmax", "mapstd"):
        # y = (x - xOffsets) * gains + yMin (mapminmax) / yMean (mapstd)
        return (x - params["x_offsets"]) * params["gains"] + params["y_offset"]
    if name == "l2normalize":
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return x / norm
    if name == "normalize":
        # min-max to [-1, 1]; a zero range fills with -1
        mn = torch.amin(x, dim=-1, keepdim=True)
        mx = torch.amax(x, dim=-1, keepdim=True)
        rng = mx - mn
        y = x * (2.0 / rng) + (0.0 - mn - mx) / rng
        return torch.where(rng == 0.0, torch.full_like(y, -1.0), y)
    if name == "normalizestd":
        # zero mean, unit population standard deviation (vDSP_normalize)
        centered = x - torch.mean(x, dim=-1, keepdim=True)
        std = torch.sqrt(torch.mean(centered * centered, dim=-1, keepdim=True))
        return centered / std
    if name == "passthrough":
        return x
    raise ValueError(f"unknown input processing function {name!r}")


def reverse_named(y: torch.Tensor, name: str, params: Params) -> torch.Tensor:
    """Apply one output-processing function's *reverse* mapping."""
    if name in ("mapminmax", "mapstd"):
        return (y - params["y_offset"]) / params["gains"] + params["x_offsets"]
    if name == "passthrough":
        return y
    raise ValueError(f"unknown output processing function {name!r}")


def specs_to_chain(
    specs: Sequence[ProcessingSpec], device
) -> tuple[tuple[str, ...], list[dict]]:
    """Split specs into (names, parameter dicts of float32 tensors)."""
    names = tuple(s.name for s in specs)
    params = []
    for s in specs:
        if s.name in ("mapminmax", "mapstd"):
            params.append(
                {
                    "x_offsets": torch.as_tensor(
                        s.x_offsets, dtype=torch.float32, device=device
                    ),
                    "gains": torch.as_tensor(
                        s.gains, dtype=torch.float32, device=device
                    ),
                    "y_offset": torch.tensor(
                        s.y_offset, dtype=torch.float32, device=device
                    ),
                }
            )
        else:
            params.append({})
    return names, params


def apply_input_chain(
    x: torch.Tensor, names: Sequence[str], params: Sequence[Params]
) -> torch.Tensor:
    """Apply the input processing chain in order; empty chain is identity."""
    for name, p in zip(names, params):
        x = apply_named(x, name, p)
    return x


def reverse_output_chain(
    y: torch.Tensor, names: Sequence[str], params: Sequence[Params]
) -> torch.Tensor:
    """Apply each output function's reverse mapping in declaration order."""
    for name, p in zip(names, params):
        y = reverse_named(y, name, p)
    return y


def _f64(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def fold_input_affines(names, procs, n_features: int):
    """Fold an affine input chain (mapminmax/mapstd after an optional leading
    l2normalize) into per-feature (scale, shift) in float64, so
    ``chain(x) = (x_or_normalized * scale) + shift``.

    Returns (scale [D], shift [D], has_l2). The fused kernel's constant
    folding rests on W @ (x*s + h) = (W*s) @ x + W @ h.
    """
    scale = np.ones(n_features, np.float64)
    shift = np.zeros(n_features, np.float64)
    has_l2 = False
    for name, p in zip(names, procs):
        if name == "l2normalize":
            has_l2 = True
        elif name in ("mapminmax", "mapstd"):
            g = _f64(p["gains"])
            xo = _f64(p["x_offsets"])
            yo = float(_f64(p["y_offset"]))
            # applied after the accumulated (scale, shift):
            # ((x*s + h) - xo) * g + yo
            shift = (shift - xo) * g + yo
            scale = scale * g
    return scale, shift, has_l2


def fold_output_affines(names, procs, n_outputs: int):
    """Fold the reverse-applied output chain into one affine ``y*a + c``
    (float64)."""
    a = np.ones(n_outputs, np.float64)
    c = np.zeros(n_outputs, np.float64)
    for name, p in zip(names, procs):
        if name in ("mapminmax", "mapstd"):
            g = _f64(p["gains"])
            xo = _f64(p["x_offsets"])
            yo = float(_f64(p["y_offset"]))
            a = a / g
            c = (c - yo) / g + xo
    return a, c
