"""Hand-written CUDA kernels for Hopper (sm_90a), each with its plain
PyTorch version beside it. Sources live in ``../csrc``; ``_build`` compiles
them with nvcc at first launch, never at import."""

from syllable_detector_tpu_torch.kernels.fused_detector import (
    fusable,
    fused_offline_outputs,
    fused_batch_offline_outputs,
    fused_flat_batch_offline_outputs,
)
from syllable_detector_tpu_torch.kernels.framed_gemm import framed_gemm

__all__ = [
    "fusable",
    "fused_offline_outputs",
    "fused_batch_offline_outputs",
    "fused_flat_batch_offline_outputs",
    "framed_gemm",
]
