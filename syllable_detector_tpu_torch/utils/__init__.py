"""Framework-free host utilities: audio file IO (``wav``, ``codecs``,
``av_codec``), CSV number formatting (``fmt``), running statistics
(``stats``), named timers (``timing``), debug logging (``logging``), the
on-demand native build (``native_build``) and synthetic labeled audio
(``synth``)."""

from syllable_detector_tpu_torch.utils.synth import make_labeled_audio

__all__ = ["make_labeled_audio"]
