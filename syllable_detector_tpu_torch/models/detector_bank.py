"""Batched multi-channel streaming detector — the live deployment shape.

Counterpart of ``syllable_detector_tpu.models.detector_bank``. The
reference runs one detector per audio channel and drains them one at a
time. :class:`DetectorBank` keeps per-lane sample buffers on the host and
evaluates every lane's new hops in ONE drain round: the lanes' samples are
staged into one ``[lanes, need]`` buffer on the wire (float32, int16 or
8-bit mu-law; pinned host memory when the bank runs on a card), copied to
the device once, evaluated by one launch of the fused kernel with one net
per lane (``kernels/fused_detector.fused_batch_program``, the wire
dequantised inside the kernel), and copied back once.

Lanes progress INDEPENDENTLY: a round evaluates the max over lanes of
newly available hops in one padded batch, and each lane's valid prefix is
reported through :attr:`last_counts` / :attr:`last_sample_indices`, so a
dead or starved lane never stalls the others. Padding rows see zero audio
(NaN under l2normalize) and are sliced away; the result array is
zero-padded.

Sample accounting is per lane and survives loss: a chunk dropped at the
``max_buffer_seconds`` cap, or a gap registered with :meth:`note_gap`,
advances the lane's stream clock and closes the current contiguous
segment (windows must not straddle missing audio), so post-gap outputs
carry their true stream sample indices and the lane re-warms like a fresh
stream.

A round is staged by the native drain stager (``native/ring_buffer.cpp``
``sdstage_batch``, one C call for all lanes) when it builds, and by numpy
otherwise; both are bit-identical to the JAX bank's staging for finite
samples. On the int16 and mu-law wires non-finite samples become 0 before
they are quantised: the native quantiser's float-to-int casts are
undefined for NaN and Inf (the JAX package's mu-law branch crashes on NaN),
so a lane that holds any is sanitised first. The float32 wire passes them
through, as the JAX bank does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu_torch.models.detector import (
    _FRAME_BUCKETS,
    deinterleave_frames,
    detector_spec_from_config,
    offline_outputs,
)
from syllable_detector_tpu_torch.models.neural_net import stack_params
from syllable_detector_tpu_torch.ops.stft import normalize_overlap, num_frames
from syllable_detector_tpu_torch.runtime.ring_buffer import DrainStager
from syllable_detector_tpu_torch.utils import timing

__all__ = ["DetectorBank", "mulaw_expand_np"]

_MU = 255.0  # continuous mu-law companding constant (8-bit wire tier)
_mulaw_lut_cache: np.ndarray | None = None
_UNSET = object()  # "program not built yet" (None = no fused program)


def _mulaw_lut() -> np.ndarray:
    """64Ki int16-code -> int8 mu-law-code lookup table (index = s16 +
    32768). Encoding goes through the int16 wire's exact clip+round first,
    so a mulaw8 stream is a strict further quantization of the int16 one."""
    global _mulaw_lut_cache
    if _mulaw_lut_cache is None:
        v = np.arange(-32768, 32768, dtype=np.float64) / 32767.0
        np.clip(v, -1.0, 1.0, out=v)
        y = np.sign(v) * np.log1p(_MU * np.abs(v)) / np.log1p(_MU)
        _mulaw_lut_cache = np.rint(y * 127.0).astype(np.int8)
    return _mulaw_lut_cache


def mulaw_expand_np(codes: np.ndarray) -> np.ndarray:
    """NumPy reference of the on-device mu-law expansion (tests/oracles)."""
    y = codes.astype(np.float64) / 127.0
    return (np.sign(y) * (np.expm1(np.abs(y) * np.log1p(_MU)) / _MU)).astype(
        np.float32
    )


@dataclasses.dataclass
class _Segment:
    """One gap-free run of a lane's stream. ``start`` is the absolute
    sample index (in the lane's true stream) of ``data[0]``; it advances
    as drained hops are trimmed. ``closed`` segments precede a gap and can
    never be extended: their remaining evaluable hops drain out, then the
    segment is discarded.

    Appends land in ``pending`` (a chunk list) and are merged into
    ``data`` lazily by :meth:`consolidate`: concatenating per append would
    copy the whole accumulated segment every chunk, turning a small-chunk
    capture loop quadratic."""

    start: int
    data: np.ndarray
    closed: bool = False
    pending: list = dataclasses.field(default_factory=list)
    pending_len: int = 0

    @property
    def total_len(self) -> int:
        return len(self.data) + self.pending_len

    def consolidate(self) -> np.ndarray:
        """Merge pending chunks into ``data`` (one concatenate) and
        return it; call before reading sample contents."""
        if self.pending:
            self.data = np.concatenate([self.data, *self.pending])
            self.pending.clear()
            self.pending_len = 0
        return self.data


class DetectorBank:
    """N streaming detectors drained together, one kernel launch a round.

    ``configs``: one per lane; all must share the first lane's pipeline
    geometry (thresholds may differ per lane: they are applied per lane).
    ``method='fused'`` (default) runs the fused kernel with one net per
    lane; ``'matmul'`` runs the unfused path vmapped over the lanes' stacked
    nets (same batching, no kernel). ``device`` is where the drains run:
    a CUDA device launches the kernel (or raises), the CPU runs its plain
    version.

    ``max_buffer_seconds`` bounds each lane's sample buffer. Appends beyond
    the cap are counted in ``overflows[lane]``, their length is added to
    ``dropped_samples[lane]``, and the lane's stream clock still advances
    (see :meth:`note_gap`).

    ``buckets`` pins the drain-shape ladder (evaluations per lane per
    round; default the JAX package's ``(8, 32, ..., 8192)``): a backlog
    beyond the largest drains in several rounds and a smaller one pads up.
    ``transfer_dtype`` is the wire: ``'int16'`` halves the host->device
    bytes (clip to [-1, 1] and round to 1/32767 steps, exact for S16
    capture), ``'mulaw8'`` quarters them (lossy mu-law companding).
    ``min_drain_hops`` > 1 leaves smaller tails buffered for a later round
    (closed pre-gap fronts drain regardless; ``drain(flush=True)`` takes
    everything).

    After each :meth:`drain`:

    * ``last_counts[lane]`` — how many of the returned rows are valid for
      that lane (the rest is padding);
    * ``last_sample_indices[lane]`` — absolute stream sample index of each
      valid output.
    """

    def __init__(
        self,
        configs: list[SyllableDetectorConfig],
        method: str = "fused",
        max_buffer_seconds: float = 30.0,
        pairs=None,
        buckets: tuple | None = None,
        transfer_dtype: str = "float32",
        min_drain_hops: int = 1,
        device="cuda",
    ):
        if not configs:
            raise ValueError("DetectorBank needs at least one lane")
        self.configs = list(configs)
        self.device = torch.device(device)
        # pairs: precomputed [(spec, params)] matching configs, so that
        # callers that built them already (Processor's geometry grouping)
        # do not build every lane's weights twice
        if pairs is None:
            pairs = [detector_spec_from_config(c, self.device) for c in self.configs]
        elif len(pairs) != len(self.configs):
            raise ValueError("pairs must match configs one-to-one")
        self.spec = pairs[0][0]
        base = dataclasses.replace(self.spec, thresholds=())
        for s, _ in pairs[1:]:
            if dataclasses.replace(s, thresholds=()) != base:
                raise ValueError(
                    "all lanes must share the first network's geometry "
                    "(sampling rate, FFT/window, band, layer sizes)"
                )
        self.params_list = [p for _, p in pairs]
        self.thresholds = np.asarray([s.thresholds[0] for s, _ in pairs], np.float64)
        if method not in ("fused", "matmul"):
            # a typo would otherwise route every drain to the unfused path
            raise ValueError(f"unknown method {method!r}; use 'fused' or 'matmul'")
        if method == "fused":
            from syllable_detector_tpu_torch.kernels.fused_detector import fusable

            if not fusable(self.spec):
                method = "matmul"
        self.method = method
        self.n_lanes = len(configs)
        self.max_buffer_samples = int(max_buffer_seconds * self.spec.sampling_rate)
        self.overflows = [0] * self.n_lanes
        self.dropped_samples = [0] * self.n_lanes
        self._segments: list[list[_Segment]] = [[] for _ in configs]
        self._offered = [0] * self.n_lanes  # absolute per-lane stream clock
        self.hops_emitted = [0] * self.n_lanes
        self.last_counts = np.zeros(self.n_lanes, np.int64)
        self.last_sample_indices: list[np.ndarray] = [
            np.zeros(0, np.int64) for _ in configs
        ]
        self.last_outputs = np.zeros((self.n_lanes, self.spec.net.outputs), np.float32)
        if buckets is None:
            self._buckets = _FRAME_BUCKETS
        else:
            self._buckets = tuple(int(b) for b in buckets)
            if (
                not self._buckets
                or any(b <= 0 for b in self._buckets)
                or list(self._buckets) != sorted(set(self._buckets))
            ):
                raise ValueError("buckets must be strictly increasing positive ints")
        if transfer_dtype not in ("float32", "int16", "mulaw8"):
            raise ValueError(
                f"unknown transfer_dtype {transfer_dtype!r}; "
                "use 'float32', 'int16' or 'mulaw8'"
            )
        self.transfer_dtype = transfer_dtype
        # one drain program per staged shape (fused method)
        self._programs: dict[int, object] = {}
        self._stacked = None  # stacked per-lane params of the matmul method
        self.min_drain_hops = int(min_drain_hops)
        # trailing partial interleaved frame awaiting its next capture
        # chunk (append_interleaved_audio_data)
        self._interleave_rem = np.zeros(0, np.float32)
        # reusable per-shape staging buffers: need -> (numpy view, tensor,
        # per-row fill of the last round). Only the stale tail [m, prev) of
        # a row is re-zeroed, so a round costs O(samples staged), not
        # O(buffer). On a card the tensor is pinned, so the round's one
        # host->device copy is asynchronous DMA.
        self._stage: dict[int, tuple[np.ndarray, torch.Tensor, np.ndarray]] = {}
        stager = DrainStager(self.n_lanes)
        self._stager = stager if stager.available else None

    # -- feeding ------------------------------------------------------------

    def buffered_samples(self, lane: int) -> int:
        """Samples currently buffered (across segments) for one lane."""
        return sum(s.total_len for s in self._segments[lane])

    def append_audio_data(self, lane: int, samples: np.ndarray) -> bool:
        """Buffer a chunk for one lane. Returns False when the chunk was
        DROPPED at the ``max_buffer_seconds`` cap (counted in
        ``overflows``/``dropped_samples``; the lane's stream clock still
        advances so later timestamps stay sample-accurate)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        n = len(samples)
        if self.buffered_samples(lane) + n > self.max_buffer_samples:
            self.note_gap(lane, n)
            return False
        segs = self._segments[lane]
        if segs and not segs[-1].closed:
            segs[-1].pending.append(samples.copy())
            segs[-1].pending_len += n
        else:
            segs.append(_Segment(start=self._offered[lane], data=samples.copy()))
        self._offered[lane] += n
        return True

    def append_interleaved_audio_data(self, samples: np.ndarray) -> list[bool]:
        """Fan an interleaved ``n_lanes``-channel capture buffer (frame-major)
        out to the lanes; returns each lane's :meth:`append_audio_data`
        flag. A trailing PARTIAL frame is kept and prepended to the next
        call, so no lane's stream clock shifts."""
        frames, self._interleave_rem = deinterleave_frames(
            samples, self._interleave_rem, self.n_lanes
        )
        return [
            self.append_audio_data(lane, np.ascontiguousarray(frames[:, lane]))
            for lane in range(self.n_lanes)
        ]

    def note_gap(self, lane: int, n: int) -> None:
        """Register ``n`` samples of the lane's stream as LOST: advance the
        stream clock so later outputs keep true sample indices, and close
        the open segment, so the lane re-warms past the gap like a fresh
        stream."""
        self.overflows[lane] += 1
        self.dropped_samples[lane] += n
        self._offered[lane] += n
        segs = self._segments[lane]
        if segs and not segs[-1].closed:
            segs[-1].closed = True

    def note_interleaved_gap(self, n: int) -> None:
        """Register a gap of ``n`` interleaved samples on the stream feeding
        all lanes: every lane loses ``n // n_lanes`` samples, and the pending
        partial frame (pre-gap audio) is dropped and counted into the gaps
        of the lanes whose samples it held."""
        per_lane = n // self.n_lanes
        rem_len = len(self._interleave_rem)
        self._interleave_rem = np.zeros(0, np.float32)
        for lane in range(self.n_lanes):
            self.note_gap(lane, per_lane + (1 if lane < rem_len else 0))

    # -- draining -----------------------------------------------------------

    def _front_avail(self, lane: int) -> int:
        """Evaluable hops of the lane's FRONT segment, discarding
        exhausted closed segments first."""
        spec = self.spec
        segs = self._segments[lane]
        while segs:
            front = segs[0]
            f = num_frames(front.total_len, spec.window_length, spec.window_overlap)
            avail = max(0, f - (spec.time_range - 1))
            if avail or not front.closed:
                return avail
            segs.pop(0)  # closed and drained dry: the gap follows
        return 0

    def _staging(self, need: int) -> tuple[np.ndarray, torch.Tensor, np.ndarray]:
        """The reusable ``[n_lanes, need]`` wire buffer of one shape."""
        if need not in self._stage:
            from syllable_detector_tpu_torch.kernels.fused_detector import WIRE_DTYPES

            t = torch.zeros(
                (self.n_lanes, need),
                dtype=WIRE_DTYPES[self.transfer_dtype],
                pin_memory=self.device.type == "cuda",
            )
            self._stage[need] = (t.numpy(), t, np.zeros(self.n_lanes, np.int64))
        return self._stage[need]

    def _stage_round(self, avail: list[int], need: int) -> torch.Tensor:
        """Quantise and copy every lane's front segment (up to ``need``
        samples) into the staging buffer of ``need``; returns its tensor."""
        xs, t, prev = self._staging(need)
        quantise = self.transfer_dtype != "float32"
        rows = []
        for i in range(self.n_lanes):
            data = self._segments[i][0].consolidate()[:need] if avail[i] > 0 else None
            if quantise and data is not None and not np.isfinite(data).all():
                data = np.nan_to_num(data, nan=0.0, posinf=0.0, neginf=0.0)
            rows.append(data)
        if self._stager is not None:
            stager = self._stager
            for i, data in enumerate(rows):
                stager.lens[i] = 0 if data is None else len(data)
                if data is not None:
                    stager.ptrs[i] = data.ctypes.data
            mode = DrainStager.MODES[self.transfer_dtype]
            lut = _mulaw_lut().ctypes.data if mode == 2 else 0
            stager.stage(xs, prev, mode, lut, keepalive=rows)
            return t
        for i, data in enumerate(rows):
            m = 0 if data is None else len(data)
            if quantise and m:
                # capture-native PCM: clip + round-to-nearest, as S16
                # capture hardware does
                q = np.clip(data, -1.0, 1.0)
                q *= np.float32(32767.0)
                np.rint(q, out=q)
                if self.transfer_dtype == "mulaw8":
                    xs[i, :m] = _mulaw_lut()[q.astype(np.int32) + 32768]
                else:
                    xs[i, :m] = q
            elif m:
                xs[i, :m] = data
            if m < prev[i]:
                xs[i, m : prev[i]] = 0
            prev[i] = m
        return t

    def drain(self, flush: bool = False) -> np.ndarray:
        """Evaluate every lane's newly available hops, one padded batched
        round per bucket -> [n_lanes, n_max, outputs] (n_max may be 0).
        Rows beyond ``last_counts[lane]`` are zero padding, and
        ``last_sample_indices[lane]`` gives each valid output's absolute
        stream sample index. ``flush=True`` ignores ``min_drain_hops``.

        Each segment keeps the trailing ``timeRange - 1`` hops of samples,
        so the next round's evaluations continue exactly where this one
        stopped.
        """
        spec = self.spec
        t = spec.time_range
        hop = spec.hop
        gap, _ = normalize_overlap(spec.window_overlap)
        first_out = spec.first_output_sample

        per_lane_outs: list[list[np.ndarray]] = [[] for _ in range(self.n_lanes)]
        per_lane_idx: list[list[np.ndarray]] = [[] for _ in range(self.n_lanes)]
        while True:
            avail = [self._front_avail(i) for i in range(self.n_lanes)]
            n_max = max(avail)
            if n_max <= 0:
                break
            if not flush and n_max < self.min_drain_hops and not any(
                a > 0 and self._segments[i][0].closed for i, a in enumerate(avail)
            ):
                break  # defer the tail; nothing urgent (no closed fronts)
            take = min(n_max, self._buckets[-1])
            bucket = next(b for b in self._buckets if b >= take)
            need = (bucket + t - 2) * hop + gap + spec.window_length
            with timing.span("bank.stage"):
                xs = self._stage_round(avail, need)
            outs = self._wire_outputs(xs)[:, :take]
            for i in range(self.n_lanes):
                take_i = min(avail[i], take)
                if take_i <= 0:
                    continue
                front = self._segments[i][0]
                per_lane_outs[i].append(outs[i, :take_i])
                per_lane_idx[i].append(
                    front.start + first_out + hop * np.arange(take_i, dtype=np.int64)
                )
                rem = front.data[take_i * hop :]
                # a small view would pin the whole pre-drain buffer; copy
                # once the remainder is under half of its base
                base = rem.base if rem.base is not None else rem
                front.data = rem.copy() if rem.nbytes * 2 < base.nbytes else rem
                front.start += take_i * hop
                self.hops_emitted[i] += take_i

        counts = np.array([sum(len(o) for o in outs) for outs in per_lane_outs], np.int64)
        n_out = int(counts.max()) if self.n_lanes else 0
        result = np.zeros((self.n_lanes, n_out, spec.net.outputs), np.float32)
        for i in range(self.n_lanes):
            if counts[i]:
                lane_rows = np.concatenate(per_lane_outs[i], axis=0)
                result[i, : counts[i]] = lane_rows
                self.last_outputs[i] = lane_rows[-1]
            self.last_sample_indices[i] = (
                np.concatenate(per_lane_idx[i]) if per_lane_idx[i] else np.zeros(0, np.int64)
            )
        self.last_counts = counts
        return result

    def _program(self, need: int):
        """The fused drain program of one staged shape (built once)."""
        prog = self._programs.get(need, _UNSET)
        if prog is _UNSET:
            from syllable_detector_tpu_torch.kernels.fused_detector import (
                fused_batch_program,
            )

            prog = fused_batch_program(
                self.spec, self.params_list, need, self.transfer_dtype, self.device
            )
            self._programs[need] = prog
        return prog

    def _wire_outputs(self, xs: torch.Tensor) -> np.ndarray:
        """One staged round -> [n_lanes, bucket, outputs] on the host: one
        host->device copy, the evaluation, one device->host copy."""
        prog = self._program(xs.shape[1]) if self.method == "fused" else None
        if prog is not None:
            with timing.span("bank.copy"):
                xd = prog.upload(xs)
            with timing.span("bank.launch"):
                out = prog.launch(xd)
        else:
            from syllable_detector_tpu_torch.kernels.fused_detector import dequant

            with timing.span("bank.copy"):
                xd = xs.to(self.device)
            with timing.span("bank.launch"):
                x = dequant(xd, self.transfer_dtype)
                if self._stacked is None:
                    self._stacked = stack_params(self.params_list)
                spec = self.spec
                out = torch.func.vmap(lambda p, xl: offline_outputs(spec, p, xl))(self._stacked, x)
        with timing.span("bank.readback"):  # the host waits here for the launch
            return out.cpu().numpy()

    def seen_syllables(self) -> np.ndarray:
        """Drain and OR detections per lane (output 0 against each lane's
        own threshold) -> bool[n_lanes]. Only each lane's valid prefix is
        consulted: padding rows never count."""
        outs = self.drain()
        if not outs.shape[1]:
            return np.zeros(self.n_lanes, bool)
        valid = np.arange(outs.shape[1])[None, :] < self.last_counts[:, None]
        # float32 comparison, like Detector.seen_syllable
        hits = outs[:, :, 0] >= self.thresholds.astype(np.float32)[:, None]
        return np.any(hits & valid, axis=1)

    # -- state checkpoint / resume (the JAX bank's formats) -----------------

    def get_state(self) -> dict:
        """Snapshot every lane's streaming state as plain numpy arrays."""
        return {
            "segments": [
                [(int(s.start), s.consolidate().copy(), bool(s.closed)) for s in segs]
                for segs in self._segments
            ],
            "offered": list(self._offered),
            "hops_emitted": list(self.hops_emitted),
            "last_outputs": np.asarray(self.last_outputs, np.float32).copy(),
            "last_counts": np.asarray(self.last_counts, np.int64).copy(),
            "last_sample_indices": [a.copy() for a in self.last_sample_indices],
            "overflows": list(self.overflows),
            "dropped_samples": list(self.dropped_samples),
            "interleave_rem": self._interleave_rem.copy(),
        }

    def set_state(self, state: dict) -> None:
        """Restore a :meth:`get_state` snapshot, this bank's or the JAX
        bank's, in either of its schemas; continuing the streams afterwards
        produces the outputs an uninterrupted bank would."""
        # legacy lockstep frame counter; 0 under the segment schema, where
        # it only backstops snapshots missing offered/hops_emitted
        legacy_fs = int(state.get("frames_seen", 0))
        if "segments" in state:
            segments = [
                [_Segment(int(st), np.asarray(d, np.float32).copy(), bool(c)) for st, d, c in segs]
                for segs in state["segments"]
            ]
        else:
            # legacy single-residual schema: residual[0] sits at absolute
            # stream sample frames_seen * hop (every emitted hop trimmed one
            # hop off the front), so the segment starts there
            start0 = legacy_fs * self.spec.hop
            segments = [
                [_Segment(start0, np.asarray(r, np.float32).copy())]
                if len(np.asarray(r).reshape(-1))
                else []
                for r in state["residuals"]
            ]
        if len(segments) != self.n_lanes:
            raise ValueError(f"state has {len(segments)} lanes, bank has {self.n_lanes}")
        self._segments = segments
        self._offered = [
            int(v)
            for v in state.get(
                "offered",
                [
                    (segs[-1].start + len(segs[-1].data)) if segs else legacy_fs * self.spec.hop
                    for segs in segments
                ],
            )
        ]
        self.hops_emitted = [
            int(v) for v in state.get("hops_emitted", [legacy_fs] * self.n_lanes)
        ]
        self.last_outputs = np.asarray(state["last_outputs"], np.float32).copy()
        # last drain's per-lane progress: restored, or reset when absent
        self.last_counts = np.asarray(
            state.get("last_counts", np.zeros(self.n_lanes, np.int64)), np.int64
        ).copy()
        lsi = state.get("last_sample_indices")
        self.last_sample_indices = (
            [np.asarray(a, np.int64).copy() for a in lsi]
            if lsi is not None
            else [np.zeros(0, np.int64) for _ in range(self.n_lanes)]
        )
        self.overflows = list(state.get("overflows", [0] * self.n_lanes))
        self.dropped_samples = list(state.get("dropped_samples", [0] * self.n_lanes))
        self._interleave_rem = np.asarray(
            state.get("interleave_rem", np.zeros(0, np.float32)), np.float32
        ).copy()

    def save_state(self, path) -> None:
        """Write :meth:`get_state` to an ``.npz`` in the JAX bank's layout."""
        state = self.get_state()
        arrays = {}
        seg_counts = []
        for i, segs in enumerate(state["segments"]):
            seg_counts.append(len(segs))
            arrays[f"seg_starts_{i}"] = np.asarray([s[0] for s in segs], np.int64)
            arrays[f"seg_closed_{i}"] = np.asarray([s[2] for s in segs], bool)
            for k, (_, d, _) in enumerate(segs):
                arrays[f"seg_data_{i}_{k}"] = d
        for i, a in enumerate(state["last_sample_indices"]):
            arrays[f"lsi_{i}"] = a
        np.savez(
            path,
            n_lanes=self.n_lanes,
            seg_counts=np.asarray(seg_counts, np.int64),
            offered=np.asarray(state["offered"], np.int64),
            hops_emitted=np.asarray(state["hops_emitted"], np.int64),
            last_outputs=state["last_outputs"],
            last_counts=state["last_counts"],
            overflows=np.asarray(state["overflows"], np.int64),
            dropped_samples=np.asarray(state["dropped_samples"], np.int64),
            interleave_rem=state["interleave_rem"],
            **arrays,
        )

    def load_state(self, path) -> None:
        """Restore a :meth:`save_state` file (or the JAX bank's legacy one)."""
        with np.load(path) as data:
            if "seg_counts" in data.files:
                segments = []
                for i, n in enumerate(data["seg_counts"]):
                    starts = data[f"seg_starts_{i}"]
                    closed = data[f"seg_closed_{i}"]
                    segments.append(
                        [
                            (int(starts[k]), data[f"seg_data_{i}_{k}"], bool(closed[k]))
                            for k in range(int(n))
                        ]
                    )
                state = {
                    "segments": segments,
                    "offered": list(data["offered"]),
                    "hops_emitted": list(data["hops_emitted"]),
                    "last_outputs": data["last_outputs"],
                    "overflows": list(data["overflows"]),
                    "dropped_samples": list(data["dropped_samples"]),
                    "interleave_rem": (
                        data["interleave_rem"]
                        if "interleave_rem" in data.files
                        else np.zeros(0, np.float32)
                    ),
                }
                if "last_counts" in data.files:
                    state["last_counts"] = data["last_counts"]
                    state["last_sample_indices"] = [
                        data[f"lsi_{i}"] for i in range(int(data["n_lanes"]))
                    ]
                self.set_state(state)
                return
            n_saved = sum(1 for k in data.files if k.startswith("residual_"))
            self.set_state(
                {
                    "residuals": [data[f"residual_{i}"] for i in range(n_saved)],
                    "frames_seen": int(data["frames_seen"]),
                    "last_outputs": data["last_outputs"],
                    "overflows": list(data["overflows"]),
                }
            )

    def warm_up(self, buckets: tuple | None = None) -> int:
        """Run one round of every drain shape (this bank's ladder by
        default) on zeros, through the same wire path drains take: the
        kernel is built and loaded, and every staging buffer and drain
        program exists before the first live round. Returns the number of
        shapes run."""
        spec = self.spec
        gap, _ = normalize_overlap(spec.window_overlap)
        buckets = buckets if buckets is not None else self._buckets
        for b in buckets:
            need = (b + spec.time_range - 2) * spec.hop + gap + spec.window_length
            self._wire_outputs(self._staging(need)[1])
        return len(buckets)
