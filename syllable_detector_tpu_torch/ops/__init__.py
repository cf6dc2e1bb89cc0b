"""L2 — signal-processing primitives as plain functions on torch tensors:
the counterparts of ``syllable_detector_tpu.ops``."""

from syllable_detector_tpu_torch.ops.stft import frequencies_for_sample_rate

__all__ = ["frequencies_for_sample_rate"]
