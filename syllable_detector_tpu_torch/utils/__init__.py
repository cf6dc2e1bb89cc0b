"""Framework-free host utilities: audio file IO (``wav``, ``codecs``,
``av_codec``), CSV number formatting (``fmt``), running statistics
(``stats``), named timers (``timing``), debug logging (``logging``), the
on-demand native build (``native_build``), synthetic labeled audio
(``synth``) and measurement helpers (``measure``)."""

from syllable_detector_tpu_torch.utils.wav import read_wav, write_wav
from syllable_detector_tpu_torch.utils.fmt import fmt_float32, fmt_double
from syllable_detector_tpu_torch.utils.stats import SummaryStat, StatMean, StatMax
from syllable_detector_tpu_torch.utils.synth import make_labeled_audio
from syllable_detector_tpu_torch.utils.timing import Time

__all__ = [
    "read_wav",
    "write_wav",
    "fmt_float32",
    "fmt_double",
    "SummaryStat",
    "StatMean",
    "StatMax",
    "Time",
    "make_labeled_audio",
]
