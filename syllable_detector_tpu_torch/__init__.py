"""syllable_detector_tpu_torch — the syllable detector on PyTorch and CUDA.

A port of ``syllable_detector_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The JAX package stays the reference: every module here mirrors the
JAX module of the same name, and the tests hold each against it.

Layer map (the JAX package's, re-targeted):

  L6  entry points .......... syllable_detector_tpu_torch.cli (offline),
                              syllable_detector_tpu_torch.monitor (live)
  L5  orchestration ......... syllable_detector_tpu_torch.runtime
                              (track_detector, processor)
  L3  detection core ........ syllable_detector_tpu_torch.models
                              (neural_net, detector, detector_bank)
  L2  signal primitives ..... syllable_detector_tpu_torch.ops
                              + kernels/ (hand-written CUDA for sm_90a, csrc/)
  L1  config/model format ... syllable_detector_tpu.config (framework-free,
                              reused by import)

This package imports ``torch`` and never ``jax``: of the JAX package it
imports only the framework-free modules ``config`` and ``utils``, and it
loads the framework-free host modules ``runtime/{ring_buffer,audio_io,
arduino}.py`` by path (``runtime._host``).
"""

__version__ = "0.1.0"
