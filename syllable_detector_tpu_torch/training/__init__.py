"""Detector training on PyTorch — the counterpart of
``syllable_detector_tpu.training``.

The reference trains its MLP offline in MATLAB and exports it to the text
format with convert_to_text.m. Here the same subset of networks (strictly
chained MLP with mapminmax/l2normalize processing) trains on a CUDA card,
data-parallel over a mesh of shards or as an ensemble of per-channel nets,
and exports to the identical text format.
"""

from syllable_detector_tpu_torch.training.checkpoint import (
    save_checkpoint,
    restore_checkpoint,
    latest_step,
)
from syllable_detector_tpu_torch.training.trainer import (
    TrainSettings,
    features_and_labels,
    fit_mapminmax,
    init_layer_params,
    train,
    train_ensemble,
    train_step,
    make_ensemble_epoch,
    export_trained_config,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "TrainSettings",
    "features_and_labels",
    "fit_mapminmax",
    "init_layer_params",
    "train",
    "train_ensemble",
    "train_step",
    "make_ensemble_epoch",
    "export_trained_config",
]
