"""L2 — signal-processing primitives as plain functions on torch tensors:
the counterparts of ``syllable_detector_tpu.ops``."""

from syllable_detector_tpu_torch.ops.windows import make_window, WINDOW_TYPES
from syllable_detector_tpu_torch.ops.stft import (
    frequency_index_range,
    frequencies_for_sample_rate,
    num_frames,
    frame_signal,
    spectral_frames,
    band_dft_matrices,
    stack_features,
)
from syllable_detector_tpu_torch.ops.processing import (
    apply_input_chain,
    reverse_output_chain,
)
from syllable_detector_tpu_torch.ops.transfer import apply_transfer
from syllable_detector_tpu_torch.ops.scaling import apply_scaling
from syllable_detector_tpu_torch.ops.resample import (
    LinearResamplerState,
    linear_resample_init,
    linear_resample_chunk,
    linear_resample_chunk_exact,
    linear_resample,
    polyphase_resample,
)

__all__ = [
    "make_window",
    "WINDOW_TYPES",
    "frequency_index_range",
    "frequencies_for_sample_rate",
    "num_frames",
    "frame_signal",
    "spectral_frames",
    "band_dft_matrices",
    "stack_features",
    "apply_input_chain",
    "reverse_output_chain",
    "apply_transfer",
    "apply_scaling",
    "LinearResamplerState",
    "linear_resample_init",
    "linear_resample_chunk",
    "linear_resample_chunk_exact",
    "linear_resample",
    "polyphase_resample",
]
