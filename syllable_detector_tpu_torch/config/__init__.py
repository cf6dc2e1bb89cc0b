"""L1 — config / model text format.

Parses and writes the `key = value` network description format produced by
the reference's MATLAB exporter (reference: convert_to_text.m:59-214) and
consumed by SyllableDetectorConfig(fromTextFile:)
(reference: Common/SyllableDetectorConfig.swift:170-278).
"""

from syllable_detector_tpu_torch.config.model_format import (
    ConfigError,
    LayerSpec,
    ProcessingSpec,
    SyllableDetectorConfig,
    load_config,
    loads_config,
    save_config,
    dumps_config,
)

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
