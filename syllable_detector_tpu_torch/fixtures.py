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
"""

from __future__ import annotations

import dataclasses

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
