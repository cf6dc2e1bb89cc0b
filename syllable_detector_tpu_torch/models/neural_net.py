"""The MATLAB-subset MLP on torch tensors.

Counterpart of ``syllable_detector_tpu.models.neural_net``: a strictly
chained feed-forward net with per-layer ``transfer(W @ x + b)`` and
input/output processing chains around it. The parameters are a dict of
tensors laid out exactly as the JAX package's pytree, so the two packages
can be fed identical weights (:func:`params_from_numpy`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu_torch.ops.processing import (
    apply_input_chain,
    reverse_output_chain,
    specs_to_chain,
)
from syllable_detector_tpu_torch.ops.transfer import apply_transfer

__all__ = [
    "NetSpec",
    "net_from_config",
    "apply_net",
    "params_from_numpy",
    "stack_params",
]


@dataclass(frozen=True)
class NetSpec:
    """Static description of a net: shapes and function names."""

    layer_sizes: tuple[tuple[int, int], ...]  # (inputs, outputs) per layer
    transfers: tuple[str, ...]
    input_processing: tuple[str, ...]
    output_processing: tuple[str, ...]

    @property
    def inputs(self) -> int:
        return self.layer_sizes[0][0]

    @property
    def outputs(self) -> int:
        return self.layer_sizes[-1][1]


def net_from_config(
    cfg: SyllableDetectorConfig, device
) -> tuple[NetSpec, dict]:
    """Build (spec, parameter dict on ``device``) from a parsed config.

    Weights keep the reference's (outputs, inputs) orientation;
    :func:`apply_net` contracts x @ W^T.
    """
    in_names, in_params = specs_to_chain(cfg.process_inputs, device)
    out_names, out_params = specs_to_chain(cfg.process_outputs, device)
    spec = NetSpec(
        layer_sizes=tuple((l.inputs, l.outputs) for l in cfg.layers),
        transfers=tuple(l.transfer for l in cfg.layers),
        input_processing=in_names,
        output_processing=out_names,
    )
    params = {
        "layers": [
            {
                "w": torch.as_tensor(l.weights, dtype=torch.float32, device=device),
                "b": torch.as_tensor(l.biases, dtype=torch.float32, device=device),
            }
            for l in cfg.layers
        ],
        "process_inputs": in_params,
        "process_outputs": out_params,
    }
    return spec, params


def params_from_numpy(tree, device):
    """The JAX package's parameter pytree, with numpy leaves (as
    ``jax.tree.map(np.asarray, params)`` gives it), as this package's
    parameter dict of float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def apply_net(spec: NetSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Forward pass over a batch: [..., inputs] -> [..., outputs]: input
    chain, layers (matmul + bias + transfer), then the output chain
    reversed."""
    x = apply_input_chain(x, spec.input_processing, params["process_inputs"])
    for transfer, layer in zip(spec.transfers, params["layers"]):
        x = apply_transfer(x @ layer["w"].T + layer["b"], transfer)
    return reverse_output_chain(
        x, spec.output_processing, params["process_outputs"]
    )


def stack_params(params_list: list[dict]) -> dict:
    """Stack per-channel parameter dicts on a new leading axis.

    All nets must share one NetSpec (same shapes and functions); the
    result feeds ``torch.func.vmap`` over channels."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_params([p[k] for p in params_list]) for k in first}
    if isinstance(first, (list, tuple)):
        return [
            stack_params([p[i] for p in params_list]) for i in range(len(first))
        ]
    return torch.stack(list(params_list))
