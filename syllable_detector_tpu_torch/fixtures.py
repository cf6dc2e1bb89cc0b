"""Seeded nets and audio for the port's tests and ``chip_smoke.py``.

The reference's own net file is not part of the repository, so the tests
build nets of its geometry with seeded random weights:
:func:`sample_geometry_config` (44.1 kHz, fft/window 256, overlap 124 so
hop 132, band 2-7 kHz = bins [12, 41), timeRange 10, 290 inputs, input
chain l2normalize -> mapminmax, output mapminmax), :func:`geometry_config`
(the same at any rate, fft, window, overlap, band, timeRange and widths, as
the train CLI's flags make them) and :func:`gap_config` (a negative
overlap). :func:`random_config` is the JAX package's fuzz generator
(``tests/test_fuzz.py``) on the port's config types, and
:func:`wide_geometry_configs` lists the geometries whose CTA does not fit
the fused kernel's resident layout. :func:`chirp_audio` is a band-sweeping chirp with a
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
from syllable_detector_tpu_torch.ops.stft import frequency_index_range

__all__ = [
    "sample_geometry_config",
    "geometry_config",
    "gap_config",
    "random_config",
    "wide_geometry_configs",
    "RESAMPLE_RATES",
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
# Common recording rates: every ordered pair of two of them is a rate pair
# the polyphase resampler serves.
RESAMPLE_RATES = (8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000,
                  176400, 192000)
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
    return geometry_config(seed, hidden=hidden, transfers=transfers, scaling=scaling)


def geometry_config(
    seed: int = 0,
    rate: float = RATE,
    fft: int = 256,
    window: int | None = None,
    overlap: int = 124,
    freq: tuple[float, float] = (2000.0, 7000.0),
    time_range: int = 10,
    hidden: tuple[int, ...] = (4,),
    transfers: tuple[str, ...] | None = None,
    scaling: str = "linear",
) -> SyllableDetectorConfig:
    """A net of the given geometry with seeded weights, its arguments named
    as the train CLI's flags (``window`` defaults to ``fft``, transfers to
    TanSig hidden layers and a PureLin output) and its input and output
    chains the sample's: l2normalize -> mapminmax in, mapminmax out."""
    if transfers is None:
        transfers = ("TanSig",) * len(hidden) + ("PureLin",)
    if len(transfers) != len(hidden) + 1:
        raise ValueError("give one transfer per hidden layer plus the output's")
    window = fft if window is None else window
    lo, hi = frequency_index_range(fft, freq[0], freq[1], rate)
    rng = np.random.default_rng(seed)
    n_in = (hi - lo) * time_range
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
        sampling_rate=float(rate),
        fourier_length=fft,
        window_length=window,
        window_overlap=overlap,
        freq_range=(float(freq[0]), float(freq[1])),
        time_range=time_range,
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


def random_config(rng: np.random.Generator) -> SyllableDetectorConfig:
    """A random fusable or unfusable geometry and net, drawn from ``rng``
    exactly as the JAX package's fuzz test draws it (``tests/test_fuzz.py``
    ``random_config``): fft 64-512, a window of fft, fft/2 or fft-24, an
    overlap, no overlap or a gap, a random band at 8, 22.05 or 44.1 kHz,
    timeRange 1-7, any scaling, 1-5 hidden units and 1-2 outputs."""
    fft = int(rng.choice([64, 128, 256, 512]))
    window = int(rng.choice([fft, fft, fft // 2, max(16, fft - 24)]))
    window = min(window, fft)
    kind = rng.choice(["overlap", "zero", "gap"])
    if kind == "overlap":
        overlap = int(rng.integers(1, window))
    elif kind == "zero":
        overlap = 0
    else:
        overlap = -int(rng.integers(1, window))
    rate = float(rng.choice([8000.0, 22050.0, 44100.0]))
    f_hi_max = rate / 2 * 0.9
    f0 = float(rng.uniform(0, f_hi_max / 2))
    f1 = float(rng.uniform(f0 + f_hi_max / 8, f_hi_max))
    bins = frequency_index_range(fft, f0, f1, rate)
    if bins is None or bins[1] - bins[0] < 1:
        f0, f1 = 0.0, f_hi_max
        bins = frequency_index_range(fft, f0, f1, rate)
    t_range = int(rng.integers(1, 8))
    n_bins = bins[1] - bins[0]
    d = n_bins * t_range
    scaling = str(rng.choice(["linear", "linear", "db", "log"]))

    hidden = int(rng.integers(1, 6))
    outputs = int(rng.integers(1, 3))
    layers = [
        LayerSpec(
            inputs=d,
            outputs=hidden,
            weights=rng.standard_normal((hidden, d)).astype(np.float32) * 0.3,
            biases=rng.standard_normal(hidden).astype(np.float32) * 0.1,
            transfer=str(rng.choice(["TanSig", "LogSig", "SatLin"])),
        ),
        LayerSpec(
            inputs=hidden,
            outputs=outputs,
            weights=rng.standard_normal((outputs, hidden)).astype(np.float32),
            biases=rng.standard_normal(outputs).astype(np.float32) * 0.1,
            transfer=str(rng.choice(["PureLin", "TanSig"])),
        ),
    ]
    process_inputs = [ProcessingSpec("l2normalize")]
    if rng.random() < 0.7:
        process_inputs.append(
            ProcessingSpec(
                "mapminmax",
                x_offsets=rng.random(d).astype(np.float32) * 1e-3,
                gains=(rng.random(d) + 0.5).astype(np.float32) * 4,
                y_offset=-1.0,
            )
        )
    process_outputs = []
    if rng.random() < 0.7:
        process_outputs.append(
            ProcessingSpec(
                "mapminmax",
                x_offsets=np.zeros(outputs, np.float32),
                gains=np.full(outputs, 2.0, np.float32),
                y_offset=-1.0,
            )
        )
    return SyllableDetectorConfig(
        sampling_rate=rate,
        fourier_length=fft,
        window_length=window,
        window_overlap=overlap,
        freq_range=(f0, f1),
        time_range=t_range,
        thresholds=[0.5] * outputs,
        scaling=scaling,
        layers=layers,
        process_inputs=process_inputs,
        process_outputs=process_outputs,
    )


def wide_geometry_configs() -> list[tuple[str, SyllableDetectorConfig]]:
    """(name, config) of geometries whose CTA does not fit the fused
    kernel's resident layout in shared memory: nets the train CLI makes
    from its own flags (44.1 kHz unless named), three of the fuzz
    generator's seeds at fft 512, and a 12-layer net at the sample
    geometry."""
    return [
        ("fft512 hidden16", geometry_config(1, fft=512, overlap=256, freq=(500.0, 15000.0),
                                            hidden=(16,))),
        ("fft1024 overlap900", geometry_config(2, fft=1024, overlap=900,
                                               freq=(500.0, 10000.0))),
        ("96k fft1024", geometry_config(3, rate=96000.0, fft=1024, overlap=512,
                                        freq=(500.0, 20000.0))),
        ("hidden64", geometry_config(4, hidden=(64,))),
        ("hidden128", geometry_config(5, hidden=(128,))),
        *((f"fuzz{seed}", random_config(np.random.default_rng(seed)))
          for seed in (1022, 1066, 1092)),
        ("deep12", geometry_config(6, hidden=(6,) * 11,
                                   transfers=("TanSig",) + ("LogSig", "SatLin") * 5 + ("PureLin",))),
    ]


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
