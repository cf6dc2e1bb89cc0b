"""Layer transfer functions, the MATLAB nnet subset: TanSig (tanh), LogSig
(1/(1+e^-x), composed as the reference composes it), PureLin (identity),
SatLin (clip to [0, 1])."""

from __future__ import annotations

import torch

__all__ = ["apply_transfer", "TRANSFER_IMPLS"]


def _tansig(x):
    return torch.tanh(x)


def _logsig(x):
    # the reference's exact composition, not torch.sigmoid
    return 1.0 / (1.0 + torch.exp(-x))


def _purelin(x):
    return x


def _satlin(x):
    return torch.clamp(x, 0.0, 1.0)


TRANSFER_IMPLS = {
    "TanSig": _tansig,
    "LogSig": _logsig,
    "PureLin": _purelin,
    "SatLin": _satlin,
}


def apply_transfer(x: torch.Tensor, name: str) -> torch.Tensor:
    try:
        return TRANSFER_IMPLS[name](x)
    except KeyError:
        raise ValueError(f"unknown transfer function {name!r}") from None
