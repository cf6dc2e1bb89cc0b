"""Synthetic labeled audio and synthetic model variants for tests, demos,
and hardware smokes.

Counterpart of ``syllable_detector_tpu.utils.synth``. The reference ships
no labeled training data; the training tests and ``chip_smoke.py`` use this
generator so that both packages train on the SAME audio.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_labeled_audio", "deepen_net"]


def make_labeled_audio(seconds=4.0, rate=44100, seed=0):
    """Syllable = loud band-limited chirp bursts; silence/noise elsewhere.

    Returns (audio float32 [n], intervals [(start_s, end_s), ...]); the
    labeled intervals sit inside the bursts (past the detector's window
    fill) so edge evaluations count as neither hits nor false alarms.
    """
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.01 * rng.standard_normal(n)
    intervals = []
    pos = 0.3
    while pos + 0.25 < seconds:
        lo, hi = pos, pos + 0.15
        # the samples with lo <= t < hi (t is sorted): the JAX generator's
        # mask, without a pass over the whole signal per burst
        m = slice(np.searchsorted(t, lo, "left"), np.searchsorted(t, hi, "left"))
        tt = t[m] - lo
        f0 = 3000.0 + 1500.0 * np.sin(2 * np.pi * 8 * tt)
        x[m] += 0.6 * np.sin(2 * np.pi * np.cumsum(f0) / rate)
        intervals.append((lo + 0.04, hi - 0.01))  # interior, past window fill
        pos += 0.55
    return x.astype(np.float32), intervals


def deepen_net(spec, params, mid_units=6, transfer="LogSig", seed=0):
    """Graft an extra hidden layer (arbitrary transfer) between a net's
    hidden layer and its output layer -> (spec2, params2).

    ``spec`` is a :class:`~syllable_detector_tpu_torch.models.detector.DetectorSpec`
    and ``params`` its parameter dict; the new layers are float32 tensors
    on the device of the first layer's weights (the same seeded draws as
    the JAX package's). This mirrors what the train CLI emits for
    ``--hidden H1 H2``.
    """
    import dataclasses

    import torch

    rng = np.random.default_rng(seed)
    layers = list(params["layers"])
    device = layers[0]["w"].device
    h1_out = layers[0]["w"].shape[0]
    n_out = layers[-1]["w"].shape[0]

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mid = {
        "w": tensor(rng.standard_normal((mid_units, h1_out)) * 0.5),
        "b": tensor(rng.standard_normal(mid_units) * 0.1),
    }
    out = {
        "w": tensor(rng.standard_normal((n_out, mid_units)) * 0.5),
        "b": layers[-1]["b"].to(torch.float32),
    }
    params2 = dict(params)
    params2["layers"] = [layers[0], mid, out]
    net2 = dataclasses.replace(
        spec.net,
        layer_sizes=(
            spec.net.layer_sizes[0],
            (h1_out, mid_units),
            (mid_units, n_out),
        ),
        transfers=(spec.net.transfers[0], transfer, spec.net.transfers[-1]),
    )
    return dataclasses.replace(spec, net=net2), params2
