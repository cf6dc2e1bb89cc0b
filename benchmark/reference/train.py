"""Plain training of a detector net: what ``train`` at its defaults computes.

Written from the training CLI's documented semantics (its ``--help`` and
the trainer's docstrings), in plain PyTorch with every gradient written out:

- features: the band magnitudes of the audio (``reference.detect``'s
  framing, window and bins) in float32, floored at 1e-12; labels: 1 where an
  evaluation's decision sample, over the rate, lies in a labeled interval;
- the input chain: l2normalize, then mapminmax fitted in float64 on the
  l2-normalized features (gain 2 / range, offset the minimum; gain 1 on a
  zero range) and applied every step;
- 4 inits drawn in turn from one CPU ``torch.Generator`` seeded with the
  seed, each layer's weights then biases uniform in +-2/sqrt(fan_in) and
  +-2; each epoch's batches a permutation from NumPy's ``default_rng(seed)``,
  ``n // bs`` batches of ``bs = min(256, n)`` rows;
- a TanSig hidden layer and a PureLin output, whose output mapminmax's
  reverse maps [-1, 1] to [0, 1]; the mean squared error to the labels;
- optax's Adam (b1 0.9, b2 0.999, eps 1e-8, its order of operations).

``precision="float32"`` is the reference; ``precision="tf32"`` rounds every
matrix product's operands to TF32, the control; ``precision="float64"``
trains on the same float32 inputs in float64, a witness of what float32
rounding alone moves.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import roofline
from benchmark.reference.detect import features as band_features
from benchmark.reference.detect import first_output_sample, matmul

B1, B2, EPS = 0.9, 0.999, 1e-8


def features_and_labels(geom: dict, audio: np.ndarray, intervals, device):
    x = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    feats = torch.clamp(band_features(geom, x, "float32"), min=1e-12)
    t = (first_output_sample(geom) + roofline.hop(geom) * np.arange(len(feats))) \
        / geom["sampling_rate"]
    labels = np.zeros(len(feats), np.float32)
    for lo, hi in intervals:
        labels[(t >= lo) & (t <= hi)] = 1.0
    return feats, torch.as_tensor(labels, device=device)


def fit_chain(feats: torch.Tensor):
    """(x_offsets, gains) float32 of the mapminmax fitted after l2normalize."""
    x = (feats / torch.sqrt(torch.sum(feats * feats, -1, keepdim=True))).cpu().numpy()
    xmin = x.min(0).astype(np.float64)
    span = x.max(0).astype(np.float64) - xmin
    gains = np.where(span > 0, 2.0 / np.where(span > 0, span, 1.0), 1.0)
    return xmin.astype(np.float32), gains.astype(np.float32)


def init(seed: int, sizes: list[int], k: int):
    g = torch.Generator().manual_seed(seed)
    nets = []
    for _ in range(k):
        layers = []
        for i in range(len(sizes) - 1):
            bound = 2.0 / np.sqrt(sizes[i])
            w = torch.empty(sizes[i + 1], sizes[i]).uniform_(-bound, bound, generator=g)
            b = torch.empty(sizes[i + 1]).uniform_(-2.0, 2.0, generator=g)
            layers.append((w, b))
        nets.append(layers)
    return [(torch.stack([n[i][0] for n in nets]), torch.stack([n[i][1] for n in nets]))
            for i in range(len(sizes) - 1)]


class Trainer:
    """The stacked nets' parameters [w1, b1, w2, b2] (leading axis: init)
    and Adam's state, stepped on batches of rows."""

    def __init__(self, geom: dict, audio, intervals, seed: int, device,
                 precision: str = "float32", n_init: int = 4, batch: int = 256):
        if len(geom["hidden"]) != 1:
            raise ValueError("the reference trains one hidden layer")
        self.precision = precision
        self.feats, self.labels = features_and_labels(geom, audio, intervals, device)
        xo, gains = fit_chain(self.feats)
        self.x_offsets = torch.as_tensor(xo, device=device)
        self.gains = torch.as_tensor(gains, device=device)
        sizes = [self.feats.shape[1], *geom["hidden"], 1]
        dtype = torch.float64 if precision == "float64" else torch.float32
        start = [t.to(device, dtype) for layer in init(seed, sizes, n_init) for t in layer]
        # one flat [K, P] tensor holds every parameter; w1, b1, w2, b2 are views
        self.flat = torch.cat([t.reshape(n_init, -1) for t in start], 1)
        self.params, at = [], 0
        for t in start:
            size = t[0].numel()
            self.params.append(self.flat[:, at : at + size].view(t.shape))
            at += size
        self.x = self.chain(self.feats).to(dtype)
        self.labels = self.labels.to(dtype)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = 0
        self.rng = np.random.default_rng(seed)
        self.n = len(self.feats)
        self.bs = min(batch, self.n)
        self.steps = self.n // self.bs

    def chain(self, x: torch.Tensor) -> torch.Tensor:
        x = x / torch.sqrt(torch.sum(x * x, -1, keepdim=True))
        return (x - self.x_offsets) * self.gains - 1.0

    def forward(self, x: torch.Tensor, params=None):
        """x [rows, D] (after the chain) -> (hidden [K, rows, H], outputs
        [K, rows])."""
        w1, b1, w2, b2 = params or self.params
        p = self.precision
        h = torch.tanh(matmul(x, w1.transpose(1, 2), p) + b1[:, None, :])
        y = matmul(h, w2.transpose(1, 2), p)[..., 0] + b2
        return h, (y + 1.0) / 2.0

    def step(self, rows: torch.Tensor, bc1: float, bc2: float) -> torch.Tensor:
        """One Adam step of every init on the batch ``rows`` (bias
        corrections ``bc1``, ``bc2``) -> the losses [K] before it."""
        p = self.precision
        x = self.x.index_select(0, rows)
        lab = self.labels.index_select(0, rows)
        w1, b1, w2, b2 = self.params
        h, pred = self.forward(x)
        err = pred - lab
        out = torch.mean(err * err, -1)
        dy = err * (1.0 / len(rows))  # d mean(err^2) / d pred, times d pred / d y = 1/2
        dz = (dy[..., None] * w2[:, 0, None, :]) * (1.0 - h * h)
        k = len(self.flat)
        g = torch.cat([matmul(dz.transpose(1, 2), x, p).reshape(k, -1), dz.sum(1),
                       matmul(dy[:, None, :], h, p).reshape(k, -1), dy.sum(1)[:, None]], 1)
        self.mu.mul_(B1).add_(g * (1 - B1))
        self.nu.mul_(B2).add_((g * g) * (1 - B2))
        self.flat.add_((self.mu / bc1) / (torch.sqrt(self.nu / bc2) + EPS) * -self.lr)
        return out

    def epoch_rows(self) -> np.ndarray:
        return self.rng.permutation(self.n)[: self.steps * self.bs].reshape(self.steps, self.bs)

    def run(self, epochs: int, lr: float) -> np.ndarray:
        """Train; returns every step's losses before it [steps, K]."""
        self.lr = lr
        count = torch.arange(1, epochs * self.steps + 1, dtype=self.flat.dtype)
        bc1 = (1 - torch.pow(B1, count)).tolist()
        bc2 = (1 - torch.pow(B2, count)).tolist()
        log = torch.empty((len(count), len(self.flat)), dtype=self.flat.dtype,
                          device=self.flat.device)
        for _ in range(epochs):
            idx = torch.as_tensor(self.epoch_rows().astype(np.int64), device=self.feats.device)
            for row in idx:
                log[self.count] = self.step(row, bc1[self.count], bc2[self.count])
                self.count += 1
        return log.cpu().numpy()
