"""Parser/writer for the syllable-detector network text format.

The format is `key = value` lines (arrays comma-separated); lines that do not
split into exactly two parts at `=` are ignored, which is how `#` comments are
skipped (reference: Common/SyllableDetectorConfig.swift:183-189,
Common/Common.swift:16-24). Schema and quirks replicated here:

  * ``fourierLength`` must be a power of two
    (SyllableDetectorConfig.swift:198-201).
  * ``windowLength`` defaults to ``fourierLength`` when absent
    (SyllableDetectorConfig.swift:204-209).
  * ``thresholds`` falls back to the legacy singular key ``threshold``
    (SyllableDetectorConfig.swift:223-229).
  * ``scaling`` is one of ``linear`` / ``log`` / ``db``
    (SyllableDetectorConfig.swift:13-30).
  * negative ``windowOverlap`` means a gap between windows
    (CircularShortTimeFourierTransform.swift:65-73).
  * per-layer weights are row-major ``outputs x inputs``
    (NeuralNet.swift:333, 366-368; convert_to_text.m:202).
  * input/output processing chains are declared by count with per-entry
    ``processInputsN.function`` keys (SyllableDetectorConfig.swift:262-273).

This module is pure Python/NumPy — no JAX — so it can run on hosts without an
accelerator and at import time in CLI tools.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import IO, Union

import numpy as np

__all__ = [
    "ConfigError",
    "LayerSpec",
    "ProcessingSpec",
    "SyllableDetectorConfig",
    "load_config",
    "loads_config",
    "save_config",
    "dumps_config",
]


class ConfigError(Exception):
    """Raised on a malformed network file.

    Mirrors SyllableDetectorConfig.ParseError's cases
    (SyllableDetectorConfig.swift:50-55): unableToOpenPath, missingValue,
    invalidValue, mismatchedLength.
    """

    def __init__(self, kind: str, name: str):
        self.kind = kind
        self.name = name
        super().__init__(f"{kind}({name!r})")


# Transfer function names accepted by the reference
# (SyllableDetectorConfig.swift:250-256).
TRANSFER_FUNCTIONS = ("TanSig", "LogSig", "PureLin", "SatLin")

# Processing function names accepted for inputs / outputs
# (SyllableDetectorConfig.swift:128-168).
INPUT_PROCESSING_FUNCTIONS = (
    "mapminmax",
    "mapstd",
    "l2normalize",
    "normalize",
    "normalizestd",
)
OUTPUT_PROCESSING_FUNCTIONS = ("mapminmax", "mapstd")

SCALINGS = ("linear", "log", "db")


@dataclass
class ProcessingSpec:
    """One element of an input/output processing chain.

    For ``mapminmax``: y = (x - x_offsets) * gains + y_offset, with
    ``y_offset`` holding yMin (NeuralNet.swift:111-144).
    For ``mapstd``: same affine form with y_offset holding yMean
    (NeuralNet.swift:146-182). Parameterless functions (l2normalize,
    normalize, normalizestd) leave the arrays empty.
    """

    name: str
    x_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    gains: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    y_offset: float = 0.0

    def __post_init__(self):
        self.x_offsets = np.asarray(self.x_offsets, dtype=np.float32)
        self.gains = np.asarray(self.gains, dtype=np.float32)
        self.y_offset = float(self.y_offset)


@dataclass
class LayerSpec:
    """One fully-connected layer: out = transfer(W @ x + b).

    ``weights`` has shape (outputs, inputs), matching the reference's
    row-major vDSP_mmul layout (NeuralNet.swift:366-368).
    """

    inputs: int
    outputs: int
    weights: np.ndarray
    biases: np.ndarray
    transfer: str

    def __post_init__(self):
        if self.inputs <= 0 or self.outputs <= 0:
            raise ConfigError("invalidValue", "layer dimensions")
        self.weights = np.asarray(self.weights, dtype=np.float32).reshape(
            self.outputs, self.inputs
        )
        self.biases = np.asarray(self.biases, dtype=np.float32).reshape(self.outputs)
        if self.transfer not in TRANSFER_FUNCTIONS:
            raise ConfigError("invalidValue", f"transferFunction {self.transfer}")


def first_output_sample(
    window_length: int, window_overlap: int, time_range: int
) -> int:
    """Sample index of the first network output — one full window plus the
    hop for each additional time step, plus the gap which applies even to
    the first window (TrackDetector.swift:38-42). The single home for this
    accounting; SyllableDetectorConfig and DetectorSpec both delegate here.
    """
    n = window_length + (window_length - window_overlap) * (time_range - 1)
    if window_overlap < 0:
        n -= window_overlap
    return n


@dataclass
class SyllableDetectorConfig:
    """Full detector description (SyllableDetectorConfig.swift:32-44)."""

    sampling_rate: float
    fourier_length: int
    window_length: int
    window_overlap: int  # negative => gap between windows
    freq_range: tuple[float, float]
    time_range: int
    thresholds: list[float]  # float64, one per network output
    scaling: str  # linear | log | db
    layers: list[LayerSpec]
    process_inputs: list[ProcessingSpec]
    process_outputs: list[ProcessingSpec]

    # ---- derived quantities -------------------------------------------------

    @property
    def net_inputs(self) -> int:
        return self.layers[0].inputs

    @property
    def net_outputs(self) -> int:
        return self.layers[-1].outputs

    @property
    def gap(self) -> int:
        """Samples skipped before each window (negative overlap semantics,
        CircularShortTimeFourierTransform.swift:65-73)."""
        return -self.window_overlap if self.window_overlap < 0 else 0

    @property
    def overlap(self) -> int:
        return self.window_overlap if self.window_overlap >= 0 else 0

    @property
    def hop(self) -> int:
        """Samples consumed per spectral frame
        (CircularShortTimeFourierTransform.swift:242, 301)."""
        return self.gap + self.window_length - self.overlap

    @property
    def first_output_sample(self) -> int:
        """Sample index of the first network output (TrackDetector.swift:38-42)."""
        return first_output_sample(
            self.window_length, self.window_overlap, self.time_range
        )

    def validate(self) -> None:
        """Construction-time guards from the reference."""
        if not _is_power_of_two(self.fourier_length):
            raise ConfigError("invalidValue", "fourierLength")
        # overlap must be strictly less than the window
        # (CircularShortTimeFourierTransform.swift:76-78)
        if self.window_overlap >= self.window_length:
            raise ConfigError("invalidValue", "windowOverlap")
        # fft >= window (CircularShortTimeFourierTransform.swift:86-88)
        if self.window_length > self.fourier_length:
            raise ConfigError("invalidValue", "windowLength")
        if self.scaling not in SCALINGS:
            raise ConfigError("invalidValue", "scaling")
        if not self.layers:
            raise ConfigError("missingValue", "layers")
        for i, layer in enumerate(self.layers):
            if i > 0 and self.layers[i - 1].outputs != layer.inputs:
                # NeuralNet.swift:248-254
                raise ConfigError("mismatchedLength", f"layer{i}.inputs")
        if len(self.thresholds) != self.net_outputs:
            # SyllableDetector.swift:57-60
            raise ConfigError("mismatchedLength", "thresholds")


def _is_power_of_two(v: int) -> bool:
    # Common.swift:26-30
    return v > 0 and (v & (v - 1)) == 0


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def _parse_lines(text: str) -> dict[str, str]:
    """Split into a key -> value dict.

    A line is accepted only when splitting at '=' yields exactly two parts;
    later duplicates overwrite earlier ones
    (SyllableDetectorConfig.swift:183-189).
    """
    data: dict[str, str] = {}
    for line in text.splitlines():
        parts = line.split("=")
        if len(parts) == 2:
            data[parts[0].strip()] = parts[1].strip()
    return data


def _get(data: dict[str, str], name: str) -> str:
    if name not in data:
        raise ConfigError("missingValue", name)
    return data[name]


def _parse_int(data: dict[str, str], name: str) -> int:
    v = _get(data, name)
    try:
        return int(v)  # strict like Swift Int.init?(String): "10.0" rejected
    except ValueError:
        raise ConfigError("invalidValue", name) from None


def _parse_double(data: dict[str, str], name: str) -> float:
    v = _get(data, name)
    try:
        return float(v)
    except ValueError:
        raise ConfigError("invalidValue", name) from None


def _parse_float(data: dict[str, str], name: str) -> np.float32:
    return np.float32(_parse_double(data, name))


def _parse_double_array(
    data: dict[str, str], name: str, count: int | None = None
) -> list[float]:
    v = _get(data, name)
    parts = [p.strip() for p in v.split(",")]
    try:
        values = [float(p) for p in parts]
    except ValueError:
        raise ConfigError("invalidValue", name) from None
    if count is not None and len(values) != count:
        raise ConfigError("mismatchedLength", name)
    return values


def _parse_float_array(data: dict[str, str], name: str, count: int) -> np.ndarray:
    values = _parse_double_array(data, name, count=None)
    if len(values) != count:
        raise ConfigError("mismatchedLength", name)
    return np.asarray(values, dtype=np.float32)


def _parse_processing(
    data: dict[str, str], prefix: str, count: int, allowed: tuple[str, ...]
) -> ProcessingSpec:
    fn = _get(data, f"{prefix}.function")
    if fn not in allowed:
        raise ConfigError("invalidValue", f"{prefix}.function")
    if fn == "mapminmax":
        return ProcessingSpec(
            name="mapminmax",
            x_offsets=_parse_float_array(data, f"{prefix}.xOffsets", count),
            gains=_parse_float_array(data, f"{prefix}.gains", count),
            y_offset=_parse_float(data, f"{prefix}.yMin"),
        )
    if fn == "mapstd":
        return ProcessingSpec(
            name="mapstd",
            x_offsets=_parse_float_array(data, f"{prefix}.xOffsets", count),
            gains=_parse_float_array(data, f"{prefix}.gains", count),
            y_offset=_parse_float(data, f"{prefix}.yMean"),
        )
    return ProcessingSpec(name=fn)


def loads_config(text: str) -> SyllableDetectorConfig:
    """Parse a network description from a string.

    Follows SyllableDetectorConfig.init(fromTextFile:)
    (SyllableDetectorConfig.swift:170-278) field by field.
    """
    data = _parse_lines(text)

    sampling_rate = _parse_double(data, "samplingRate")

    fourier_length = _parse_int(data, "fourierLength")
    if not _is_power_of_two(fourier_length):
        raise ConfigError("invalidValue", "fourierLength")

    if "windowLength" not in data:
        window_length = fourier_length
    else:
        window_length = _parse_int(data, "windowLength")

    window_overlap = _parse_int(data, "windowOverlap")

    freq_range = _parse_double_array(data, "freqRange", count=2)

    time_range = _parse_int(data, "timeRange")

    try:
        thresholds = _parse_double_array(data, "thresholds")
    except ConfigError:
        thresholds = _parse_double_array(data, "threshold")

    scaling = _get(data, "scaling")
    if scaling not in SCALINGS:
        raise ConfigError("invalidValue", "scaling")

    layer_count = _parse_int(data, "layers")
    layers: list[LayerSpec] = []
    for i in range(layer_count):
        inputs = _parse_int(data, f"layer{i}.inputs")
        outputs = _parse_int(data, f"layer{i}.outputs")
        weights = _parse_float_array(data, f"layer{i}.weights", inputs * outputs)
        biases = _parse_float_array(data, f"layer{i}.biases", outputs)
        transfer = _get(data, f"layer{i}.transferFunction")
        if transfer not in TRANSFER_FUNCTIONS:
            raise ConfigError("invalidValue", f"layer{i}.transferFunction")
        layers.append(
            LayerSpec(
                inputs=inputs,
                outputs=outputs,
                weights=weights,
                biases=biases,
                transfer=transfer,
            )
        )
    if not layers:
        raise ConfigError("invalidValue", "layers")

    process_inputs_count = _parse_int(data, "processInputsCount")
    process_inputs = [
        _parse_processing(
            data, f"processInputs{i}", layers[0].inputs, INPUT_PROCESSING_FUNCTIONS
        )
        for i in range(process_inputs_count)
    ]

    process_outputs_count = _parse_int(data, "processOutputsCount")
    process_outputs = [
        _parse_processing(
            data, f"processOutputs{i}", layers[-1].outputs, OUTPUT_PROCESSING_FUNCTIONS
        )
        for i in range(process_outputs_count)
    ]

    cfg = SyllableDetectorConfig(
        sampling_rate=sampling_rate,
        fourier_length=fourier_length,
        window_length=window_length,
        window_overlap=window_overlap,
        freq_range=(freq_range[0], freq_range[1]),
        time_range=time_range,
        thresholds=thresholds,
        scaling=scaling,
        layers=layers,
        process_inputs=process_inputs,
        process_outputs=process_outputs,
    )
    cfg.validate()
    return cfg


def load_config(path: Union[str, os.PathLike]) -> SyllableDetectorConfig:
    """Load a network description from a text file."""
    try:
        with open(path, "r") as fh:
            text = fh.read()
    except OSError:
        raise ConfigError("unableToOpenPath", str(path)) from None
    return loads_config(text)


# ---------------------------------------------------------------------------
# writing — the convert_to_text.m equivalent for nets trained in this
# framework (reference: convert_to_text.m:59-214)
# ---------------------------------------------------------------------------


def _fmt(v: float) -> str:
    """Shortest round-trip decimal (MATLAB used %.15g; repr is lossless)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_array(a) -> str:
    return ", ".join(_fmt(float(x)) for x in np.asarray(a).reshape(-1))


def dumps_config(cfg: SyllableDetectorConfig) -> str:
    """Serialize to the text format, loadable by this parser *and* by the
    reference Swift implementation."""
    cfg.validate()
    lines = ["# AUTOMATICALLY GENERATED SYLLABLE DETECTOR CONFIGURATION"]
    lines.append(f"samplingRate = {_fmt(cfg.sampling_rate)}")
    lines.append(f"fourierLength = {cfg.fourier_length}")
    lines.append(f"windowLength = {cfg.window_length}")
    lines.append(f"windowOverlap = {cfg.window_overlap}")
    lines.append(f"freqRange = {_fmt(cfg.freq_range[0])}, {_fmt(cfg.freq_range[1])}")
    lines.append(f"timeRange = {cfg.time_range}")
    lines.append(f"thresholds = {_fmt_array(cfg.thresholds)}")
    lines.append(f"scaling = {cfg.scaling}")
    lines.append(f"processInputsCount = {len(cfg.process_inputs)}")
    for i, p in enumerate(cfg.process_inputs):
        lines.extend(_dump_processing(f"processInputs{i}", p))
    lines.append(f"processOutputsCount = {len(cfg.process_outputs)}")
    for i, p in enumerate(cfg.process_outputs):
        lines.extend(_dump_processing(f"processOutputs{i}", p))
    lines.append(f"layers = {len(cfg.layers)}")
    for i, layer in enumerate(cfg.layers):
        lines.append(f"layer{i}.inputs = {layer.inputs}")
        lines.append(f"layer{i}.outputs = {layer.outputs}")
        # row-major outputs x inputs, matching reshape(w', [], 1)
        # (convert_to_text.m:202)
        lines.append(f"layer{i}.weights = {_fmt_array(layer.weights)}")
        lines.append(f"layer{i}.biases = {_fmt_array(layer.biases)}")
        lines.append(f"layer{i}.transferFunction = {layer.transfer}")
    return "\n".join(lines) + "\n"


def _dump_processing(prefix: str, p: ProcessingSpec) -> list[str]:
    lines = [f"{prefix}.function = {p.name}"]
    if p.name == "mapminmax":
        lines.append(f"{prefix}.xOffsets = {_fmt_array(p.x_offsets)}")
        lines.append(f"{prefix}.gains = {_fmt_array(p.gains)}")
        lines.append(f"{prefix}.yMin = {_fmt(p.y_offset)}")
    elif p.name == "mapstd":
        lines.append(f"{prefix}.xOffsets = {_fmt_array(p.x_offsets)}")
        lines.append(f"{prefix}.gains = {_fmt_array(p.gains)}")
        lines.append(f"{prefix}.yMean = {_fmt(p.y_offset)}")
    return lines


def save_config(cfg: SyllableDetectorConfig, path: Union[str, os.PathLike, IO[str]]) -> None:
    text = dumps_config(cfg)
    if hasattr(path, "write"):
        path.write(text)
    else:
        with open(path, "w") as fh:
            fh.write(text)
