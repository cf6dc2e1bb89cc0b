"""Training checkpoint/resume.

Counterpart of ``syllable_detector_tpu.training.checkpoint``, on
``torch.save`` in place of orbax: a checkpoint of step N is the directory
``step_%08d`` under the checkpoint directory, holding ``state.pt``, a tree of
dicts, lists and tuples whose leaves are CPU tensors or Python scalars. It
is read back with ``torch.load(weights_only=True)``. A checkpoint of this
package is not an orbax checkpoint, and the JAX package cannot read it.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_STATE = "state.pt"


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    return tree


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` (dicts, lists and tuples of tensors, numpy arrays or
    scalars) under directory/step_N; returns the path. The step directory
    appears whole or not at all: it is written under a temporary name and
    renamed."""
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_host(state), os.path.join(tmp, _STATE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _into(template, saved):
    """``saved`` in the structure of ``template``: containers keep the
    template's types, and each tensor leaf takes the template leaf's dtype
    and device."""
    if isinstance(template, dict):
        return {k: _into(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(
                f"checkpoint holds {len(saved)} entries where the template "
                f"has {len(template)}"
            )
        return type(template)(_into(t, s) for t, s in zip(template, saved))
    if isinstance(template, torch.Tensor):
        saved = torch.as_tensor(saved)
        if saved.shape != template.shape:
            raise ValueError(
                f"checkpoint leaf of shape {tuple(saved.shape)} where the "
                f"template has {tuple(template.shape)}"
            )
        return saved.to(device=template.device, dtype=template.dtype)
    return saved


def restore_checkpoint(
    directory: str, step: Optional[int] = None, template: Any = None
) -> Any:
    """Restore the given (or latest) step's state; None if none exists.

    Without ``template`` the leaves come back as CPU tensors. With it, the
    state is restored INTO the template's structure: its container types
    (the optimizer state's tuple), and each tensor on the template leaf's
    device with its dtype.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}", _STATE)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return state
    return _into(template, state)
