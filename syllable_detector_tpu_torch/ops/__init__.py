"""L2 — signal-processing primitives as plain functions on torch tensors:
the counterparts of ``syllable_detector_tpu.ops``."""
