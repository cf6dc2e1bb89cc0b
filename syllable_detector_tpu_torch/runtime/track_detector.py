"""Offline per-track pipeline with exact sample accounting.

Counterpart of ``syllable_detector_tpu.runtime.track_detector``: stream a
track through a detector, number every network evaluation in *input
sample* units, emit a CSV line for each detection and debounce later ones.

  * the first evaluation lands at sample
    ``window + (window - overlap) * (timeRange - 1)``, plus the gap when the
    overlap is negative;
  * each later evaluation advances ``window - overlap`` samples;
  * a detection is *any* output >= its threshold, compared in float64;
  * detections within ``debounceFrames`` of the last *printed* detection
    are suppressed;
  * CSV columns: channel, sample, seconds, out0[, out1...].
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from syllable_detector_tpu_torch.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu_torch.utils.fmt import fmt_double, fmt_float32
from syllable_detector_tpu_torch.models.detector import Detector

__all__ = ["TrackDetector"]


class TrackDetector:
    def __init__(
        self,
        config: SyllableDetectorConfig,
        channel: int = 0,
        emit: Optional[Callable[[str], None]] = None,
        method: str = "matmul",
        device="cuda",
    ):
        self.detector = Detector(config, method=method, device=device)
        self.config = config
        self.channel = channel
        self.emit = emit if emit is not None else print
        self.debounce_frames = 0
        self._debounce_until = -1
        self._next_output = config.first_output_sample

    @property
    def debounce_time(self) -> float:
        return self.debounce_frames / self.config.sampling_rate

    @debounce_time.setter
    def debounce_time(self, seconds: float) -> None:
        # truncates, as the reference's Int(newValue * samplingRate)
        self.debounce_frames = int(seconds * self.config.sampling_rate)

    def process(self, samples: np.ndarray) -> None:
        """Feed one decoded buffer and emit CSV lines for new detections."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if len(samples) == 0:
            return

        self.detector.append_audio_data(samples)
        outputs = self.detector.drain()

        rate = self.config.sampling_rate
        thresholds = np.asarray(self.config.thresholds, np.float64)
        for row in outputs:
            cur_output = self._next_output
            self._next_output += self.config.window_length - self.config.window_overlap

            # the comparison promotes the float32 output to double
            has_detection = bool(np.any(row.astype(np.float64) >= thresholds))

            if has_detection and self._debounce_until < cur_output:
                line = f"{self.channel},{cur_output},{fmt_double(cur_output / rate)}"
                for d in row:
                    line += f",{fmt_float32(d)}"
                self.emit(line)
                self._debounce_until = cur_output + self.debounce_frames
