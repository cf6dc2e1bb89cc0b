"""Traffic synthesis: song-like audio, labeled audio, nets and thresholds.

Frozen copies, so that a later change of the port's test helpers cannot move
the yardstick:

- :func:`chirp` is ``syllable_detector_tpu_torch/fixtures.py:378-391``
  (``chirp_audio``): a 2-7 kHz chirp in 3 Hz amplitude bursts with seeded
  noise and one stretch of digital silence. It runs in torch on the run's
  device and draws its noise from a ``torch.Generator`` there, where the
  original draws from NumPy on the host, so that a corpus is made in
  milliseconds.
- :func:`labeled_audio` is ``syllable_detector_tpu_torch/utils/synth.py:19-45``
  (``make_labeled_audio``), unchanged.
- :func:`net` draws the weights of ``fixtures.py:116-160``
  (``geometry_config``) from a ``torch.Generator`` on the device.
- :func:`pick_thresholds` is ``fixtures.py:417-448`` on outputs that the
  plain reference computed.
- :func:`write_wav_s16` / :func:`write_wav_f32` write the files the program
  reads; the S16 values are what the reference reads too.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from benchmark import roofline


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def chirp(n: int, rate: float, gen: torch.Generator, device) -> torch.Tensor:
    """float64 [n] on ``device``: the chirp, bursts, noise and silence."""
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    phase = 2 * math.pi * torch.cumsum(
        torch.linspace(2000.0, 7000.0, n, dtype=torch.float64, device=device), 0) / rate
    env = 0.3 + 0.7 * (torch.sin(2 * math.pi * 3.0 * t) > 0).to(torch.float64)
    noise = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    x = (0.5 * torch.sin(phase) + 0.02 * noise) * env
    lo = int(0.4 * n)
    x[lo : lo + min(int(0.1 * rate), int(0.2 * n))] = 0.0
    return x


def to_s16(x: torch.Tensor, scale: float) -> torch.Tensor:
    """int16 codes of ``x`` at ``scale`` codes a unit, rounded and clipped."""
    return torch.clamp(torch.round(x * scale), -32768, 32767).to(torch.int16)


def labeled_audio(seconds: float, rate: int, seed: int):
    """(float32 [n], [(start_s, end_s)]): loud chirp bursts every 0.55 s in
    noise; each labeled interval sits inside its burst."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.01 * rng.standard_normal(n)
    intervals = []
    pos = 0.3
    while pos + 0.25 < seconds:
        lo, hi = pos, pos + 0.15
        m = slice(np.searchsorted(t, lo, "left"), np.searchsorted(t, hi, "left"))
        tt = t[m] - lo
        f0 = 3000.0 + 1500.0 * np.sin(2 * np.pi * 8 * tt)
        x[m] += 0.6 * np.sin(2 * np.pi * np.cumsum(f0) / rate)
        intervals.append((lo + 0.04, hi - 0.01))
        pos += 0.55
    return x.astype(np.float32), intervals


def net(geom: dict, gen: torch.Generator, device) -> dict:
    """A seeded net of the geometry, as float32 numpy arrays: ``layers``
    [(w [out, in], b [out], transfer)], the input mapminmax (``x_offsets``,
    ``gains``, y offset -1 after l2normalize) and the output mapminmax (gain
    2, y offset -1). Weights are normal * 1.5 / sqrt(fan_in), biases normal
    * 0.1, offsets uniform in [-0.1, 0), gains in [5, 10)."""
    sizes = roofline.layer_sizes(geom)
    n_in = sizes[0][0]

    def draw(shape, scale, shift=0.0, kind="normal"):
        if kind == "normal":
            t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        else:
            t = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return (t * scale + shift).cpu().numpy()

    layers = [(draw((o, i), 1.5 / math.sqrt(i)), draw((o,), 0.1), tr)
              for (i, o), tr in zip(sizes, geom["transfers"])]
    return {
        "layers": layers,
        "x_offsets": draw((n_in,), 0.1, -0.1, "uniform"),
        "gains": draw((n_in,), 5.0, 5.0, "uniform"),
    }


def pick_thresholds(outputs: np.ndarray, margin: float, quantile: float = 0.75) -> float:
    """A threshold at least ``margin`` away from every finite output in
    ``outputs`` (the first output column of every evaluation), as near the
    ``quantile`` of those outputs as such a gap allows."""
    v = np.unique(outputs[np.isfinite(outputs)].astype(np.float64))
    gaps = np.flatnonzero(np.diff(v) > 2 * margin)
    if not len(gaps):
        raise ValueError("no gap of 2*margin between the outputs")
    mids = (v[gaps] + v[gaps + 1]) / 2
    return float(mids[np.argmin(abs(mids - np.quantile(v, quantile)))])


def _write_wav(path: str, payload: bytes, channels: int, rate: int, fmt: int, bits: int):
    block = channels * bits // 8
    head = struct.pack("<HHIIHH", fmt, channels, int(rate), int(rate) * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(head)) + head
    body += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body) + len(payload)) + body)
        fh.write(payload)


def write_wav_s16(path: str, codes: np.ndarray, rate: int) -> None:
    """PCM 16-bit WAV of int16 ``codes`` [n, channels]."""
    _write_wav(path, np.ascontiguousarray(codes, "<i2").tobytes(), codes.shape[1], rate, 1, 16)


def write_wav_f32(path: str, samples: np.ndarray, rate: int) -> None:
    """IEEE float 32-bit WAV of ``samples`` [n] or [n, channels]."""
    samples = np.asarray(samples, "<f4").reshape(len(samples), -1)
    _write_wav(path, samples.tobytes(), samples.shape[1], rate, 3, 32)
