"""Live multi-channel pipeline orchestration on PyTorch.

Counterpart of ``syllable_detector_tpu.runtime.processor``: one detector
per configured entry, fan-out from the audio input callback, a lock-free
ring handoff from the capture thread to one serial processing worker,
per-channel input-RMS and max-output stats, and a pluggable output backend
fired once per drain with "seen syllable":

  * :class:`AudioTTLOutput` — a 1 ms high pulse on the paired output channel;
  * :class:`ArduinoTTLOutput` — a digital write on pin 7 + channel, held for
    20 drains and refreshed on retrigger;
  * :class:`CallbackOutput` — any Python callable.

The capture thread only produces into the native SPSC ring; all detector
math runs on the worker. ``batched=True`` drains every lane's new hops
through one :class:`~syllable_detector_tpu_torch.models.detector_bank.DetectorBank`
per pipeline geometry (one kernel launch a round on a card); otherwise
each lane has its own :class:`~syllable_detector_tpu_torch.models.detector.Detector`.
The rings, the audio interfaces and the Arduino transports are this
package's framework-free host modules (``runtime.ring_buffer``,
``runtime.audio_io``, ``runtime.arduino``).
"""

from __future__ import annotations

import dataclasses
import math
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from time import perf_counter_ns as _time_ns
from typing import Optional

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu_torch.models.detector import (
    _FRAME_BUCKETS,
    Detector,
    detector_spec_from_config,
)
from syllable_detector_tpu_torch.ops.resample import (
    LinearResamplerState,
    linear_resample_chunk_exact,
    linear_resample_init,
)
from syllable_detector_tpu_torch.runtime.arduino import ArduinoIO, ArduinoPin
from syllable_detector_tpu_torch.runtime.audio_io import (
    AudioInputInterface,
    AudioOutputInterface,
)
from syllable_detector_tpu_torch.runtime.ring_buffer import RingBlockWriter, RingBuffer
from syllable_detector_tpu_torch.utils import timing
from syllable_detector_tpu_torch.utils.fmt import fmt_double, fmt_float32
from syllable_detector_tpu_torch.utils.stats import StatMax, SummaryStat
from syllable_detector_tpu_torch.utils.timing import Time

__all__ = [
    "ProcessorEntry",
    "Processor",
    "OutputBackend",
    "AudioTTLOutput",
    "ArduinoTTLOutput",
    "CallbackOutput",
    "csv_event_log",
]


def csv_event_log(fh):
    """A :class:`Processor` ``event_log`` sink writing the offline CLI's CSV
    contract, ``channel,sample,seconds,out0[,out1...]`` with the same float
    formatting, for live detections. Flushes per row, so that a crash loses
    no event."""

    def log(channel, sample, seconds, outputs):
        row = f"{channel},{sample},{fmt_double(seconds)}"
        for v in outputs:
            row += f",{fmt_float32(v)}"
        fh.write(row + "\n")
        fh.flush()

    return log


@dataclass
class ProcessorEntry:
    """One input channel -> detector -> output channel lane."""

    input_channel: int
    output_channel: int
    config: Optional[SyllableDetectorConfig] = None
    network: str = ""
    resample_from: Optional[float] = None  # device rate if != net rate


class OutputBackend:
    def set_up(self, entries: list[ProcessorEntry]) -> None:
        pass

    def tear_down(self) -> None:
        pass

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        raise NotImplementedError


class AudioTTLOutput(OutputBackend):
    """A 1 ms high pulse on the entry's output channel."""

    HIGH_DURATION = 0.001

    def __init__(self, interface: AudioOutputInterface):
        self.interface = interface

    def set_up(self, entries: list[ProcessorEntry]) -> None:
        self.interface.initialize_audio()

    def tear_down(self) -> None:
        self.interface.tear_down_audio()

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        if seen:
            self.interface.create_high_output(entry.output_channel, self.HIGH_DURATION)


class ArduinoTTLOutput(OutputBackend):
    """Pin 7 + channel digital write with a 20-drain hold counter."""

    HIGH_STEPS = 20

    def __init__(self, arduino: ArduinoIO):
        self.arduino = arduino
        self._high_count: list[int] = []

    def set_up(self, entries: list[ProcessorEntry]) -> None:
        self._high_count = [0] * len(entries)
        for e in entries:
            self.arduino.set_pin_mode(7 + e.output_channel, ArduinoPin.OUTPUT)

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        if seen:
            if self._high_count[index] == 0:
                self.arduino.write_digital(7 + entry.output_channel, True)
            self._high_count[index] = self.HIGH_STEPS
        elif self._high_count[index] > 0:
            self._high_count[index] -= 1
            if self._high_count[index] == 0:
                self.arduino.write_digital(7 + entry.output_channel, False)


class CallbackOutput(OutputBackend):
    """Invoke a Python callable per drain; base for file and log sinks."""

    def __init__(self, fn):
        self.fn = fn

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        self.fn(index, entry, seen)


@dataclass
class _Lane:
    entry: ProcessorEntry
    detector: Optional[Detector]  # None in batched-drain mode
    ring: RingBuffer
    resampler: Optional[LinearResamplerState]
    stat_input: SummaryStat
    stat_output: SummaryStat
    detections: int = 0
    # ring drops, written by the capture thread only; the worker's bank-cap
    # drops count in bank_* (one writer per field, so no increment is lost)
    overflows: int = 0
    dropped_samples: int = 0
    bank_overflows: int = 0
    bank_dropped_samples: int = 0
    last_audio_ns: Optional[int] = None  # stamp of the last capture callback
    # when the ring last went from drained to holding samples: set by the
    # capture thread, taken (and cleared) by the round that drains the lane
    pending_ns: Optional[int] = None
    # gap bookkeeping between the two threads: the capture thread records
    # each loss as (produced_samples at that time, n lost); the worker
    # splices the gap in at exactly that stream position (list append and
    # prefix del are atomic under the GIL)
    produced_samples: int = 0
    appended_samples: int = 0
    gap_events: list = field(default_factory=list)
    gap_acked: int = 0
    capture_gaps: int = 0  # device-side losses (xruns)
    capture_lost_samples: int = 0
    # per-lane stream clock of the per-lane drain mode: output k of the
    # current gap-free segment ends at segment_start + first_output_sample
    # + k * hop (batched mode reads DetectorBank.last_sample_indices)
    segment_start: int = 0
    segment_fed: int = 0
    evals_done: int = 0


class Processor:
    """Capture fan-out, one worker thread, detectors and an output backend.

    ``device`` is where every detector runs (default ``cuda``; a missing card
    raises when the first detector is built, and nothing moves to the CPU
    unless asked). ``batched=True`` groups lanes by pipeline geometry and
    drains each group through one ``DetectorBank`` (``method`` default
    ``fused``); per-lane mode gives each lane a ``Detector`` (``method``
    default ``matmul``). A failed drain is counted in ``drain_errors`` and
    the first one is kept in ``first_drain_error``; the worker carries on,
    so callers must read the counter.
    """

    def __init__(
        self,
        interface_input: AudioInputInterface,
        entries: list[ProcessorEntry],
        output: OutputBackend,
        ring_seconds: float = 10.0,
        batched: bool = False,
        method: Optional[str] = None,
        event_log=None,
        bank_buffer_seconds: float = 30.0,
        bank_buckets: Optional[tuple] = None,
        bank_transfer_dtype: str = "float32",
        bank_min_drain_hops: int = 1,
        drain_interval: float = 0.0,
        device="cuda",
    ):
        self.entries = [e for e in entries if e.config is not None]
        self.output = output
        self.interface_input = interface_input
        self.device = torch.device(device)
        # optional detection sink, called on the worker thread as
        # event_log(input_channel, sample_index, seconds, outputs_row) for
        # every output with outputs[0] >= thresholds[0] (the live rule)
        self.event_log = event_log

        self._banks: list = []  # (DetectorBank, [lane indices])
        self._bank = None  # the bank when there is one group
        if batched and self.entries:
            from syllable_detector_tpu_torch.models.detector_bank import DetectorBank

            groups: dict = {}
            pairs = [detector_spec_from_config(e.config, self.device) for e in self.entries]
            for i, (spec_i, _) in enumerate(pairs):
                groups.setdefault(dataclasses.replace(spec_i, thresholds=()), []).append(i)
            for idxs in groups.values():
                bank = DetectorBank(
                    [self.entries[i].config for i in idxs],
                    method=method or "fused",
                    pairs=[pairs[i] for i in idxs],
                    max_buffer_seconds=bank_buffer_seconds,
                    buckets=bank_buckets,
                    transfer_dtype=bank_transfer_dtype,
                    min_drain_hops=bank_min_drain_hops,
                    device=self.device,
                )
                self._banks.append((bank, idxs))
            if len(self._banks) == 1:
                self._bank = self._banks[0][0]

        self._lanes: list[_Lane] = []
        for e in self.entries:
            rate = e.config.sampling_rate
            resampler = None
            if e.resample_from is not None and abs(e.resample_from - rate) > 1.0:
                # a resampler only when the rates differ by more than 1 Hz
                resampler = linear_resample_init(e.resample_from, rate)
            self._lanes.append(
                _Lane(
                    entry=e,
                    detector=None
                    if self._banks
                    else Detector(e.config, method=method or "matmul", device=self.device),
                    ring=RingBuffer(int(ring_seconds * rate)),
                    resampler=resampler,
                    stat_input=SummaryStat(StatMax()),
                    stat_output=SummaryStat(StatMax()),
                )
            )

        # channel -> lane index map
        max_ch = max((e.input_channel for e in self.entries), default=-1)
        self._channels = [-1] * (1 + max_ch)
        for i, e in enumerate(self.entries):
            self._channels[e.input_channel] = i

        self._work: "queue.Queue[int]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # batched mode: coalesce capture chunks for up to this long between
        # bank drains (latency traded for fewer, larger rounds)
        self._drain_interval = float(drain_interval)
        self._last_drain = 0.0
        self.drain_errors = 0
        self.first_drain_error: Optional[str] = None
        self.output_errors = 0

        # one native produce call for a whole [C, n] block, when every device
        # channel maps to a lane at device rate (a resampled row changes
        # length, so such deployments take the per-lane loop)
        self._block_writer = None
        if self._channels and all(i >= 0 for i in self._channels) and all(
            self._lanes[i].resampler is None for i in self._channels
        ):
            self._block_writer = RingBlockWriter([self._lanes[i].ring for i in self._channels])

        interface_input.delegate = self.receive_audio
        interface_input.block_delegate = self.receive_audio_block
        interface_input.gap_delegate = self.receive_capture_gap

    # -- lifecycle ------------------------------------------------------------

    def set_up(self) -> None:
        self.output.set_up(self.entries)
        self._stop.clear()
        self._worker = threading.Thread(target=self._process_loop, daemon=True)
        self._worker.start()
        self.interface_input.initialize_audio()

    def tear_down(self) -> None:
        # the worker stops even if the input's teardown raises
        try:
            self.interface_input.tear_down_audio()
        finally:
            self._stop.set()
            self._work.put(-1)
            if self._worker is not None:
                self._worker.join(timeout=10)
                self._worker = None
            self.output.tear_down()

    # -- capture thread ---------------------------------------------------------

    def _produce(self, lane: _Lane, index: int, data: np.ndarray) -> None:
        """Resample (if the lane needs it) and produce into the lane's ring;
        a full ring drops the chunk and records where the hole sits."""
        if lane.resampler is not None:
            data, lane.resampler = linear_resample_chunk_exact(data, lane.resampler)
        if not lane.ring.produce(data):
            lane.overflows += 1
            lane.dropped_samples += len(data)
            lane.gap_events.append((lane.produced_samples, len(data)))
            return
        lane.produced_samples += len(data)
        if lane.pending_ns is None:
            lane.pending_ns = _time_ns()
        self._work.put(index)

    def receive_audio(self, interface, channel: int, data: np.ndarray) -> None:
        if channel >= len(self._channels):
            return
        index = self._channels[channel]
        if index < 0:
            return
        lane = self._lanes[index]
        data = np.asarray(data, np.float32)
        lane.stat_input.write_value(float(np.mean(data * data)))
        lane.last_audio_ns = _time_ns()
        self._produce(lane, index, data)

    def receive_audio_block(self, interface, block: np.ndarray) -> None:
        """Bulk capture delivery: one ``[channels, n]`` block per device read,
        the same as one :meth:`receive_audio` per row, with the level stats
        computed across lanes at once."""
        block = np.asarray(block, np.float32)
        n_ch, n = block.shape
        ms = np.einsum("ij,ij->i", block, block) / max(n, 1)
        now = _time_ns()
        channels = self._channels
        lanes = self._lanes
        writer = self._block_writer
        if writer is not None and n_ch == len(channels):
            ok = writer.produce(block)
            for ch in range(n_ch):
                lane = lanes[channels[ch]]
                lane.stat_input.write_value(float(ms[ch]))
                lane.last_audio_ns = now
                if ok[ch]:
                    lane.produced_samples += n
                    if lane.pending_ns is None:
                        lane.pending_ns = now
                    self._work.put(channels[ch])
                else:
                    lane.overflows += 1
                    lane.dropped_samples += n
                    lane.gap_events.append((lane.produced_samples, n))
            return
        for ch in range(min(n_ch, len(channels))):
            index = channels[ch]
            if index < 0:
                continue
            lane = lanes[index]
            lane.stat_input.write_value(float(ms[ch]))
            lane.last_audio_ns = now
            self._produce(lane, index, block[ch])

    def receive_capture_gap(self, interface, lost_frames: int) -> None:
        """The capture device lost ``lost_frames`` frames (an xrun): splice a
        gap of the equivalent lane-rate length into every lane at its
        current stream position. Called on the capture thread."""
        if lost_frames <= 0:
            return
        for lane in self._lanes:
            e = lane.entry
            if lane.resampler is not None:
                rate = e.config.sampling_rate
                lost = int(round(lost_frames * rate / e.resample_from))
                # the resampler's carry refers to pre-gap audio: start fresh
                lane.resampler = linear_resample_init(e.resample_from, rate)
            else:
                lost = int(lost_frames)
            if lost <= 0:
                continue
            lane.capture_gaps += 1
            lane.capture_lost_samples += lost
            lane.gap_events.append((lane.produced_samples, lost))

    # -- worker -----------------------------------------------------------------

    def _take_queued(self, indices: list) -> int:
        """Batched mode: absorb queued work items (for the drain interval,
        then whatever is queued) into ``indices``; returns how many."""
        extra = 0
        if self._drain_interval > 0:
            deadline = self._last_drain + self._drain_interval
            while not self._stop.is_set():
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    j = self._work.get(timeout=wait)
                except queue.Empty:
                    break
                extra += 1
                if j >= 0:
                    indices.append(j)
        while True:
            try:
                j = self._work.get_nowait()
            except queue.Empty:
                return extra
            extra += 1
            if j >= 0:
                indices.append(j)

    def _process_loop(self) -> None:
        while not self._stop.is_set():
            try:
                index = self._work.get(timeout=0.1)
            except queue.Empty:
                continue
            # batched mode coalesces every queued item into one round and
            # remembers which lanes' capture chunks it covers: the quiet TTL
            # decay fires for those only, once per chunk as in per-lane mode
            indices = [] if index < 0 else [index]
            extra = self._take_queued(indices) if self._banks else 0
            try:
                if not indices:
                    continue
                try:
                    if self._banks:
                        if self._drain_interval > 0:
                            self._last_drain = time.monotonic()
                        self._drain_all(set(indices))
                    else:
                        self._drain_lane(index, self._lanes[index])
                except Exception as e:
                    self._report_drain_error(f"lane {index}", e)
            finally:
                for _ in range(1 + extra):
                    self._work.task_done()

    def _report_drain_error(self, where: str, e: Exception) -> None:
        # the worker survives a failed drain, so it is counted, the first
        # one kept, and the first few printed: a kernel that fails every
        # round shows in drain_errors, never as silence
        self.drain_errors += 1
        message = f"{type(e).__name__}: {e}"
        if self.first_drain_error is None:
            self.first_drain_error = message
        if self.drain_errors <= 5:
            print(f"processor: drain error on {where}: {message}", file=sys.stderr)

    def _feed_with_gaps(self, lane: _Lane, samples, append_fn, gap_fn) -> None:
        """Feed consumed ring samples to the sink, splicing each recorded gap
        in at its true stream position: a gap event carries the lane's
        produced-sample count when it happened, which locates the hole in
        the worker's cumulative appended count."""
        base = lane.appended_samples
        n = len(samples)
        pos = 0
        while lane.gap_acked < len(lane.gap_events):
            marker, dropped = lane.gap_events[lane.gap_acked]
            cut = marker - base
            if cut > n:
                break  # the gap lies beyond the samples consumed so far
            cut = max(cut, pos)
            if cut > pos:
                append_fn(samples[pos:cut])
            pos = cut
            gap_fn(dropped)
            lane.gap_acked += 1
        if pos < n:
            append_fn(samples[pos:] if pos else samples)
        lane.appended_samples = base + n
        if lane.gap_acked:
            del lane.gap_events[: lane.gap_acked]
            lane.gap_acked = 0

    def _log_events(self, lane: _Lane, indices, outs) -> None:
        """``event_log`` rows for a drain's detections (outputs[0] >=
        thresholds[0]); a failing sink counts as an output error."""
        cfg = lane.entry.config
        thr = np.float32(cfg.thresholds[0])
        rate = cfg.sampling_rate
        for k in np.flatnonzero(outs[:, 0] >= thr):
            try:
                self.event_log(
                    lane.entry.input_channel,
                    int(indices[k]),
                    float(indices[k] / rate),
                    np.asarray(outs[k], np.float32),
                )
            except Exception as e:
                self._report_output_error(lane.entry.input_channel, e)
                return

    def _report_output_error(self, index, e) -> None:
        self.output_errors += 1
        if self.output_errors <= 5:
            print(
                f"processor: output backend error on lane {index}: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )

    @staticmethod
    def _note_queue_wait(lanes) -> None:
        """``processor.queue_wait``: from the earliest moment one of
        ``lanes``' rings held samples no round had taken to now, the start of
        the round that takes them. A stamp set between this and the round's
        read of the ring belongs to samples that round takes, and overstates
        the next round's wait by at most a round."""
        stamps = []
        for lane in lanes:
            if lane.pending_ns is not None:
                stamps.append(lane.pending_ns)
                lane.pending_ns = None
        if stamps:
            timing.record("processor.queue_wait", min(stamps), _time_ns())

    def _drain_lane(self, index: int, lane: _Lane) -> None:
        self._note_queue_wait([lane])
        t_start = _time_ns()
        samples = lane.ring.peek()
        if len(samples):
            lane.ring.consume(len(samples))
        det = lane.detector
        spec = det.spec
        out_parts = []

        def feed(chunk):
            lane.segment_fed += len(chunk)
            det.append_audio_data(chunk)

        def flush():
            part = det.drain()
            if len(part):
                out_parts.append(part)
                if self.event_log is not None:
                    k = np.arange(lane.evals_done, lane.evals_done + len(part), dtype=np.int64)
                    idx = lane.segment_start + spec.first_output_sample + k * spec.hop
                    self._log_events(lane, idx, part)
                lane.evals_done += len(part)

        def on_gap(n_lost):
            # drain the evaluable pre-gap hops, then re-warm past the hole;
            # the clock advances over the fed segment and the gap
            flush()
            det.note_gap(n_lost)
            lane.segment_start += lane.segment_fed + n_lost
            lane.segment_fed = 0
            lane.evals_done = 0

        self._feed_with_gaps(lane, samples, feed, on_gap)
        flush()
        outs = (
            np.concatenate(out_parts, axis=0)
            if out_parts
            else np.zeros((0, spec.net.outputs), np.float32)
        )
        Time.save_with_name("process" if len(outs) else "skip", _time_ns() - t_start)
        seen = False
        if len(outs):
            lane.stat_output.write_value(float(np.max(outs[:, 0])))
            n_hits = int(np.sum(outs[:, 0] >= np.float32(spec.thresholds[0])))
            if n_hits:
                seen = True
                lane.detections += n_hits
        try:
            self.output.prepare_output(index, lane.entry, seen)
        except Exception as e:
            self._report_output_error(index, e)

    def _drain_all(self, drained: Optional[set] = None) -> None:
        """Batched mode: move every lane's ring into its group's bank and
        drain each bank once. ``drained`` holds the lanes whose capture
        chunks this round covers (default: all); the quiet TTL decay
        (prepare_output with seen=False) fires for those only."""
        if drained is None:
            drained = set(range(len(self._lanes)))
        self._note_queue_wait(self._lanes)
        with timing.span("process") as round_span:
            any_outs = False
            seen_flags = [False] * len(self._lanes)
            for bank, idxs in self._banks:
                # a failure in one group leaves the others' detections standing
                try:
                    for j, i in enumerate(idxs):
                        lane = self._lanes[i]
                        samples = lane.ring.peek()
                        if len(samples):
                            lane.ring.consume(len(samples))

                        def append(chunk, j=j, lane=lane, bank=bank):
                            if not bank.append_audio_data(j, chunk):
                                # the bank's buffer cap dropped the chunk
                                lane.bank_overflows += 1
                                lane.bank_dropped_samples += len(chunk)

                        self._feed_with_gaps(
                            lane, samples, append,
                            lambda n_lost, j=j, bank=bank: bank.note_gap(j, n_lost),
                        )
                    outs = bank.drain()  # [len(idxs), n_max, outputs], padded
                    counts = bank.last_counts
                except Exception as e:
                    self._report_drain_error(f"lanes {idxs}", e)
                    continue
                if outs.shape[1]:
                    any_outs = True
                for j, i in enumerate(idxs):
                    lane = self._lanes[i]
                    o = outs[j, : counts[j]]  # this lane's valid prefix
                    if o.shape[0]:
                        lane.stat_output.write_value(float(np.max(o[:, 0])))
                        # float32 comparison, as in the per-lane drain
                        n_hits = int(np.sum(o[:, 0] >= np.float32(bank.thresholds[j])))
                        if n_hits:
                            seen_flags[i] = True
                            lane.detections += n_hits
                        if self.event_log is not None:
                            self._log_events(lane, bank.last_sample_indices[j], o)
            round_span.name = "process" if any_outs else "skip"
        for i, lane in enumerate(self._lanes):
            if not (seen_flags[i] or i in drained):
                continue
            try:
                self.output.prepare_output(i, lane.entry, seen_flags[i])
            except Exception as e:
                self._report_output_error(i, e)

    def warm_up(self, buckets=None) -> int:
        """Run every drain shape this processor can hit once (each bank's
        ladder, or each lane detector's buckets) before capture starts, so
        that no live round builds the kernel. Returns the shapes run."""
        if self._banks:
            buckets = tuple(buckets) if buckets is not None else None
            return sum(b.warm_up(buckets=buckets) for b, _ in self._banks)
        buckets = tuple(buckets) if buckets is not None else _FRAME_BUCKETS
        return sum(lane.detector.warm_up(buckets=buckets) for lane in self._lanes)

    def drain_pending(self, timeout: float = 10.0) -> None:
        """Block until all queued work has been processed (not merely
        dequeued), or ``timeout`` seconds pass."""
        deadline = time.monotonic() + timeout
        with self._work.all_tasks_done:
            while self._work.unfinished_tasks and time.monotonic() < deadline:
                self._work.all_tasks_done.wait(timeout=0.05)

    # -- stats ------------------------------------------------------------------

    def get_input_for_channel(self, channel: int) -> Optional[float]:
        index = self._index_for(channel)
        if index is None:
            return None
        v = self._lanes[index].stat_input.read_stat_and_reset()
        return math.sqrt(v) if v is not None else None

    def get_output_for_channel(self, channel: int) -> Optional[float]:
        index = self._index_for(channel)
        if index is None:
            return None
        return self._lanes[index].stat_output.read_stat_and_reset()

    def _index_for(self, channel: int) -> Optional[int]:
        if channel >= len(self._channels):
            return None
        i = self._channels[channel]
        return i if i >= 0 else None

    def lane_detections(self) -> list[int]:
        """Per-lane detection counts (lane order == ``entries`` order)."""
        return [lane.detections for lane in self._lanes]

    def lane_stats(self) -> list[dict]:
        """Per-lane counters: detections, host-side drops, device-side
        losses, and the seconds since the lane's capture last delivered."""
        now = _time_ns()
        return [
            {
                "input_channel": lane.entry.input_channel,
                "output_channel": lane.entry.output_channel,
                "detections": lane.detections,
                "overflows": lane.overflows + lane.bank_overflows,
                "dropped_samples": lane.dropped_samples + lane.bank_dropped_samples,
                "capture_gaps": lane.capture_gaps,
                "capture_lost_samples": lane.capture_lost_samples,
                "last_audio_age_s": (
                    (now - lane.last_audio_ns) / 1e9 if lane.last_audio_ns is not None else None
                ),
            }
            for lane in self._lanes
        ]
