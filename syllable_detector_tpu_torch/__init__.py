"""syllable_detector_tpu_torch — the syllable detector on PyTorch and CUDA.

A port of ``syllable_detector_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The JAX package stays the reference: every module here mirrors the
JAX module of the same name, and the tests hold each against it.

Layer map (the JAX package's, re-targeted):

  L6  entry points .......... syllable_detector_tpu_torch.cli (offline,
                              --batched -> corpus), .sim (simulator),
                              .monitor (live)
  L5  orchestration ......... syllable_detector_tpu_torch.corpus (batched
                              scan), .runtime (track_detector, processor;
                              ring_buffer, audio_io, arduino)
  L3  detection core ........ syllable_detector_tpu_torch.models
                              (neural_net, detector, detector_bank)
  L2  signal primitives ..... syllable_detector_tpu_torch.ops
                              + kernels/ (hand-written CUDA for sm_90a, csrc/)
  L1  config/model format ... syllable_detector_tpu_torch.config, with the
                              host utilities in .utils (framework-free)

This package imports ``torch`` and never ``jax``, and nothing of the JAX
package: its framework-free modules (``config``, ``utils``, the ring buffer,
the audio interfaces and the Arduino transports) are copies of the JAX
package's, and the native libraries they use are built from ``native/``
into ``build/native/``.
"""

__version__ = "0.1.0"
