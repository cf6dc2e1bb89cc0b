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

        cfg = self.config
        lines, self._debounce_until, _ = _detection_lines(
            cfg, outputs, self.channel, self._next_output, self.debounce_frames,
            self._debounce_until,
        )
        self._next_output += (cfg.window_length - cfg.window_overlap) * len(outputs)
        for line in lines:
            self.emit(line)


def _detection_lines(
    cfg: SyllableDetectorConfig,
    outputs: np.ndarray,
    channel: int,
    first_sample: int,
    debounce_frames: int,
    debounce_until: int,
) -> tuple[list[str], int, int]:
    """CSV lines of ``outputs`` [E, outputs], row k at sample ``first_sample
    + hop * k`` -> (lines, the new ``debounce_until``, rows over threshold).

    Every row is tested against its thresholds in one array compare (float64,
    as the reference promotes; NaN never detects); only the rows that pass
    are walked, in order, for the debounce and the line. A row that misses
    never touches the debounce state, so skipping it is exact.
    """
    hop = cfg.window_length - cfg.window_overlap
    thr = np.asarray(cfg.thresholds, np.float64)
    hits = np.flatnonzero((outputs.astype(np.float64) >= thr).any(axis=1))
    lines = []
    for k in hits.tolist():
        cur = first_sample + hop * k
        if debounce_until < cur:
            line = f"{channel},{cur},{fmt_double(cur / cfg.sampling_rate)}"
            for d in outputs[k]:
                line += f",{fmt_float32(d)}"
            lines.append(line)
            debounce_until = cur + debounce_frames
    return lines, debounce_until, len(hits)
