"""L3 — detection core: the MLP (``neural_net``), the detector pipeline
(``detector``) and the batched multi-lane bank (``detector_bank``)."""

from syllable_detector_tpu_torch.models.neural_net import (
    NetSpec,
    net_from_config,
    apply_net,
    stack_params,
)
from syllable_detector_tpu_torch.models.detector import (
    Detector,
    DetectorSpec,
    detect_features,
    offline_outputs,
    streaming_init,
    streaming_step,
    streaming_scan,
)

__all__ = [
    "NetSpec",
    "net_from_config",
    "apply_net",
    "stack_params",
    "Detector",
    "DetectorSpec",
    "detect_features",
    "offline_outputs",
    "streaming_init",
    "streaming_step",
    "streaming_scan",
]
