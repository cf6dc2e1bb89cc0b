"""Seeded nets and audio for the port's tests and ``chip_smoke.py``.

The reference's own net file is not part of the repository, so the tests
build nets of its geometry with seeded random weights:
:func:`sample_geometry_config` (44.1 kHz, fft/window 256, overlap 124 so
hop 132, band 2-7 kHz = bins [12, 41), timeRange 10, 290 inputs, input
chain l2normalize -> mapminmax, output mapminmax) and :func:`gap_config`
(a negative overlap). :func:`chirp_audio` is a band-sweeping chirp with a
stretch of digital silence, and :func:`pick_thresholds` places each
threshold well away from every output on given audio, so that no decision
can flip between two implementations that agree within tolerance.
:class:`ReplayAlsa` and :class:`ReplayPulse` stand in for libasound and
libpulse-simple: they capture given audio on every channel and record the
TTL waveform played back, so the live capture path runs without a sound
card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import time

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import (
    LayerSpec,
    ProcessingSpec,
    SyllableDetectorConfig,
    loads_config,
)

__all__ = [
    "sample_geometry_config",
    "gap_config",
    "chirp_audio",
    "fused_cases",
    "pick_thresholds",
    "FRAMED_GEMM_GEOMETRIES",
    "RESAMPLE_PAIRS",
    "TIER_CASES",
    "ReplayAlsa",
    "ReplayPulse",
]

RATE = 44100

# (window, window_overlap) framings the framed GEMM kernel is held against
# its plain version on, as the JAX package's tests/test_framed_gemm.py
# frames them: the sample net's (hop 132), no overlap, a gap, tiny frames, a
# window over two hops, and a long overlap.
FRAMED_GEMM_GEOMETRIES = ((256, 124), (256, 0), (200, -56), (64, 32), (300, 236), (330, 300))
# (in_rate, out_rate) pairs of the polyphase resampler: 147/160, 160/147,
# 147/320, 441/320 and 2/1 (hop 1).
RESAMPLE_PAIRS = (
    (48000.0, 44100.0),
    (44100.0, 48000.0),
    (96000.0, 44100.0),
    (32000.0, 44100.0),
    (22050.0, 44100.0),
)

# precision tier -> (the fused entries' keywords for it, rtol, atol): the
# tolerance a tier is held to against its plain version and against the JAX
# kernel run with the same keywords. rtol=2e-3, atol=5e-4 is the JAX
# package's bound for its split tiers, 1e-2 / 1e-2 its own for split=4; one
# bf16 pass (fast) keeps about three digits.
TIER_CASES = {
    "fast": ({"fast": True}, 1e-2, 1e-2),
    "split": ({"split": True}, 2e-3, 5e-4),
    "conv": ({"split": "conv"}, 2e-3, 5e-4),
    "split4": ({"split": 4}, 1e-2, 1e-2),
}


def sample_geometry_config(
    seed: int = 0,
    hidden: tuple[int, ...] = (4,),
    transfers: tuple[str, ...] = ("TanSig", "PureLin"),
    scaling: str = "linear",
) -> SyllableDetectorConfig:
    """A net of the reference sample's geometry with seeded weights."""
    if len(transfers) != len(hidden) + 1:
        raise ValueError("give one transfer per hidden layer plus the output's")
    rng = np.random.default_rng(seed)
    n_in = 29 * 10
    widths = (n_in, *hidden, 1)
    layers = [
        LayerSpec(
            inputs=i,
            outputs=o,
            weights=rng.standard_normal((o, i)) * (1.5 / np.sqrt(i)),
            biases=rng.standard_normal(o) * 0.1,
            transfer=t,
        )
        for i, o, t in zip(widths[:-1], widths[1:], transfers)
    ]
    cfg = SyllableDetectorConfig(
        sampling_rate=float(RATE),
        fourier_length=256,
        window_length=256,
        window_overlap=124,
        freq_range=(2000.0, 7000.0),
        time_range=10,
        thresholds=[0.5],
        scaling=scaling,
        layers=layers,
        process_inputs=[
            ProcessingSpec("l2normalize"),
            ProcessingSpec(
                "mapminmax",
                x_offsets=rng.uniform(-0.1, 0.0, n_in),
                gains=rng.uniform(5.0, 10.0, n_in),
                y_offset=-1.0,
            ),
        ],
        process_outputs=[
            ProcessingSpec("mapminmax", x_offsets=[0.0], gains=[2.0], y_offset=-1.0)
        ],
    )
    cfg.validate()
    return cfg


def gap_config() -> SyllableDetectorConfig:
    """A small net with a negative overlap (a 16-sample gap before every
    window): 8 kHz, fft/window 64, band 100-3000 Hz, timeRange 3."""
    text = (
        "samplingRate = 8000\nfourierLength = 64\nwindowLength = 64\n"
        "windowOverlap = -16\nfreqRange = 100, 3000\ntimeRange = 3\n"
        "thresholds = 0.5\nscaling = linear\nprocessInputsCount = 1\n"
        "processInputs0.function = l2normalize\nprocessOutputsCount = 0\n"
        "layers = 1\nlayer0.inputs = 72\nlayer0.outputs = 1\n"
        "layer0.weights = " + ", ".join(["0.1"] * 72) + "\n"
        "layer0.biases = 0\nlayer0.transferFunction = TanSig\n"
    )
    return loads_config(text)


def chirp_audio(seconds: float, seed: int = 0, rate: int = RATE) -> np.ndarray:
    """A 2-7 kHz chirp in 3 Hz amplitude bursts plus seeded noise, with one
    stretch of digital silence (exact zeros, long enough that whole
    evaluation windows see nothing): float32 [n]."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    phase = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, n)) / rate
    env = 0.3 + 0.7 * (np.sin(2 * np.pi * 3.0 * t) > 0)
    x = (0.5 * np.sin(phase) + 0.02 * rng.standard_normal(n)) * env
    lo = int(0.4 * n)
    x[lo : lo + min(int(0.1 * rate), int(0.2 * n))] = 0.0
    return x.astype(np.float32)


def fused_cases(seconds: float) -> list[tuple[str, SyllableDetectorConfig, np.ndarray, float, float]]:
    """(name, config, audio, rtol, atol) for each configuration the fused
    kernel is held against its plain version on: the sample geometry under
    each scaling, input shorter than one tile, a gap geometry, and a
    3-layer net with LogSig and SatLin hidden layers. Tolerances are the
    JAX fused kernel's own against its unfused path (rtol=1e-3,
    atol=2e-4; 2e-3/5e-4 where log/dB scaling amplifies rounding)."""
    noise = np.random.default_rng(2).standard_normal(int(seconds * 8000))
    return [
        ("linear", sample_geometry_config(0), chirp_audio(seconds, 1), 1e-3, 2e-4),
        ("log", sample_geometry_config(0, scaling="log"), chirp_audio(seconds, 1), 2e-3, 5e-4),
        ("db", sample_geometry_config(0, scaling="db"), chirp_audio(seconds, 1), 2e-3, 5e-4),
        ("short", sample_geometry_config(0), chirp_audio(0.1, 3), 1e-3, 2e-4),
        ("gap", gap_config(), noise.astype(np.float32), 1e-3, 2e-4),
        (
            "deep",
            sample_geometry_config(
                0, hidden=(8, 6), transfers=("LogSig", "SatLin", "PureLin")
            ),
            chirp_audio(seconds, 4),
            1e-3,
            2e-4,
        ),
    ]


def pick_thresholds(
    cfg: SyllableDetectorConfig,
    audio: np.ndarray,
    margin: float = 1e-3,
    quantile: float = 0.75,
    device="cpu",
) -> SyllableDetectorConfig:
    """``cfg`` with each threshold at least ``margin`` away from every
    finite output the net gives on ``audio`` ([n] or [n, channels]),
    as near the ``quantile`` of those outputs as such a gap allows. The
    outputs are computed on ``device``."""
    from syllable_detector_tpu_torch.models.detector import (
        detector_spec_from_config,
        offline_outputs,
    )

    spec, params = detector_spec_from_config(cfg, device)
    audio = np.asarray(audio, np.float32)
    channels = audio.reshape(len(audio), -1).T
    outs = np.concatenate(
        [
            offline_outputs(spec, params, torch.from_numpy(c.copy()).to(device)).cpu().numpy()
            for c in channels
        ]
    )
    thresholds = []
    for col in outs.T:
        v = np.unique(col[np.isfinite(col)].astype(np.float64))
        gaps = np.flatnonzero(np.diff(v) > 2 * margin)
        if not len(gaps):
            raise ValueError("no gap of 2*margin between the outputs")
        mids = (v[gaps] + v[gaps + 1]) / 2
        thresholds.append(float(mids[np.argmin(abs(mids - np.quantile(v, quantile)))]))
    return dataclasses.replace(cfg, thresholds=thresholds)


class _Replay:
    """What both fake sound libraries share: capture replays ``audio`` (one
    channel, the same on every captured channel) until ``total`` frames
    are delivered, then has nothing more; playback counts each channel's
    TTL pulses (rising edges of the rendered waveform), paced at
    ``rate``."""

    def __init__(self, audio: np.ndarray, channels: int, total: int | None = None,
                 rate: float = RATE):
        self.audio = np.asarray(audio, np.float32)
        self.channels = channels
        self.total = len(self.audio) if total is None else int(total)
        self.rate = rate
        self.delivered = 0
        self.pulses = np.zeros(channels, np.int64)
        self._last = np.zeros(channels, np.float32)
        self._lock = threading.Lock()

    def _capture(self, ptr, frames: int) -> int:
        """Copy up to ``frames`` interleaved frames to ``ptr``; 0 when done."""
        with self._lock:
            k = min(frames, self.total - self.delivered)
            chunk = self.audio[self.delivered : self.delivered + k]
            self.delivered += k
        if k <= 0:
            time.sleep(0.005)
            return 0
        block = np.ascontiguousarray(np.repeat(chunk, self.channels))
        ctypes.memmove(ptr, block.ctypes.data, block.nbytes)
        return k

    def _playback(self, ptr, frames: int) -> None:
        wave = np.frombuffer(
            ctypes.string_at(ptr, frames * self.channels * 4), np.float32
        ).reshape(frames, self.channels)
        with self._lock:
            prev = np.concatenate([self._last[None], wave])
            self.pulses += ((prev[1:] > 0) & (prev[:-1] == 0)).sum(axis=0)
            self._last = wave[-1].copy()
        time.sleep(frames / self.rate)


class ReplayAlsa(_Replay):
    """A libasound handle for ``runtime.alsa`` (inject it as the module's
    ``_load_alsa`` result): capture PCMs replay the audio, playback PCMs
    count TTL pulses. Device enumeration finds nothing."""

    def snd_pcm_open(self, handle_ref, name, stream, mode):
        return 0

    def snd_pcm_set_params(self, h, fmt, access, channels, rate, resample, latency):
        return 0 if channels == self.channels else -22

    def snd_pcm_readi(self, h, ptr, frames):
        return self._capture(ptr, int(frames))

    def snd_pcm_writei(self, h, ptr, frames):
        self._playback(ptr, int(frames))
        return int(frames)

    def snd_pcm_recover(self, h, err, silent):
        return 0

    def snd_pcm_close(self, h):
        return 0

    def snd_device_name_hint(self, card, iface, hints_ref):
        return -1


class ReplayPulse(_Replay):
    """A libpulse-simple handle for ``runtime.pulse`` (inject it as the
    module's ``_load_pulse`` result). The simple API's reads fill the whole
    buffer, so ``total`` should be a multiple of the reader's frames; once
    the audio is spent a read fails, which the reader counts and retries."""

    def pa_simple_new(self, server, name, direction, dev, stream_name, spec_ref,
                      chmap, attr_ref, err_ref):
        return int(direction)

    def pa_simple_read(self, h, ptr, nbytes, err_ref):
        frames = int(nbytes) // (4 * self.channels)
        if self.total - self.delivered < frames:
            time.sleep(0.005)
            return -1
        self._capture(ptr, frames)
        return 0

    def pa_simple_write(self, h, ptr, nbytes, err_ref):
        self._playback(ptr, int(nbytes) // (4 * self.channels))
        return 0

    def pa_simple_free(self, h):
        pass

    def pa_strerror(self, err):
        return b"replay"
