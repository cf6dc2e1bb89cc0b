"""Detection pipeline core on torch tensors.

Counterpart of ``syllable_detector_tpu.models.detector``:

  * :func:`offline_outputs` — whole-signal evaluation: hop-strided frames ->
    band-limited windowed DFT (one matmul) -> magnitude -> sliding feature
    stack -> scaling -> MLP. The unfused path and the port's oracle.
  * :func:`offline_outputs_batch` — the same over ``[C, n]`` streams with
    one shared net or one net per channel (``torch.func.vmap``).
  * :func:`streaming_init`, :func:`streaming_step`, :func:`streaming_scan` —
    fixed-shape streaming with a (residual samples, frame history) carry,
    the form the mesh shards over lanes.
  * :class:`Detector` — host-side object with the reference's
    appendAudioData / processNewValue semantics for arbitrary chunk sizes,
    draining either through the unfused path (``matmul`` / ``rfft``) or
    through the fused CUDA kernel (``fused``).

Validation mirrors the reference's init: net inputs must equal bins x
timeRange and the threshold count must equal the net's outputs. The
detector always uses the hamming window and |X| magnitudes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import (
    SyllableDetectorConfig,
    first_output_sample,
)
from syllable_detector_tpu_torch.models.neural_net import (
    NetSpec,
    apply_net,
    net_from_config,
    stack_params,
)
from syllable_detector_tpu_torch.ops.scaling import apply_scaling
from syllable_detector_tpu_torch.ops.stft import (
    frame_signal,
    frequency_index_range,
    hop_length,
    normalize_overlap,
    num_frames,
    spectral_frames,
    stack_features,
)

__all__ = [
    "DetectorSpec",
    "detector_spec_from_config",
    "detect_features",
    "offline_outputs",
    "offline_outputs_batch",
    "streaming_init",
    "streaming_step",
    "streaming_scan",
    "deinterleave_frames",
    "Detector",
    "MAX_DRAIN_FRAMES",
]

WINDOW = "hamming"  # forced by the detector, whatever the STFT default

# Largest number of frames (unfused) or evaluations (fused) one drain step
# computes: the JAX package's largest drain bucket. A larger backlog is
# drained in steps of this size.
MAX_DRAIN_FRAMES = 8192

# Drain shapes the batched bank pads a round to (evaluations per lane), and
# the shapes warm_up builds: the JAX package's bucket ladder.
_FRAME_BUCKETS = (8, 32, 128, 512, 2048, 8192)


@dataclass(frozen=True)
class DetectorSpec:
    """Hashable static description of one detector pipeline."""

    sampling_rate: float
    fourier_length: int
    window_length: int
    window_overlap: int  # raw; negative = gap
    time_range: int
    scaling: str
    bins: tuple[int, int]  # [lo, hi) band of DFT bins
    thresholds: tuple[float, ...]
    net: NetSpec

    @property
    def n_bins(self) -> int:
        return self.bins[1] - self.bins[0]

    @property
    def hop(self) -> int:
        return hop_length(self.window_length, self.window_overlap)

    @property
    def history(self) -> int:
        """Frames of history carried between evals (timeRange - 1)."""
        return self.time_range - 1

    @property
    def residual(self) -> int:
        """Samples left in the ring after each consumed hop."""
        return normalize_overlap(self.window_overlap)[1]

    @property
    def first_output_sample(self) -> int:
        return first_output_sample(
            self.window_length, self.window_overlap, self.time_range
        )


def detector_spec_from_config(
    cfg: SyllableDetectorConfig, device
) -> tuple[DetectorSpec, dict]:
    """Build (spec, net params on ``device``) with the reference's
    init-time checks."""
    bins = frequency_index_range(
        cfg.fourier_length, cfg.freq_range[0], cfg.freq_range[1], cfg.sampling_rate
    )
    if bins is None:
        raise ValueError("The frequency range is invalid.")
    net_spec, params = net_from_config(cfg, device)
    expected_inputs = (bins[1] - bins[0]) * cfg.time_range
    if expected_inputs != net_spec.inputs:
        raise ValueError(
            f"The neural network has {net_spec.inputs} inputs, but the "
            f"configuration settings suggest there should be {expected_inputs}."
        )
    if len(cfg.thresholds) != net_spec.outputs:
        raise ValueError(
            f"The neural network has {net_spec.outputs} outputs, but the "
            f"configuration settings suggest there should be "
            f"{len(cfg.thresholds)}."
        )
    spec = DetectorSpec(
        sampling_rate=float(cfg.sampling_rate),
        fourier_length=cfg.fourier_length,
        window_length=cfg.window_length,
        window_overlap=cfg.window_overlap,
        time_range=cfg.time_range,
        scaling=cfg.scaling,
        bins=bins,
        thresholds=tuple(float(t) for t in cfg.thresholds),
        net=net_spec,
    )
    return spec, params


def detect_features(
    spec: DetectorSpec, params: dict, features: torch.Tensor
) -> torch.Tensor:
    """[..., timeRange*bins] feature vectors -> [..., outputs]: spectrogram
    scaling, then the net."""
    return apply_net(spec.net, params, apply_scaling(features, spec.scaling))


def _band(spec: DetectorSpec, samples: torch.Tensor, n_frames: int, method: str):
    frames = frame_signal(
        samples, n_frames, spec.window_length, spec.window_overlap
    )
    return spectral_frames(
        frames,
        spec.fourier_length,
        window_type=WINDOW,
        bins=spec.bins,
        kind="magnitude",
        method=method,
    )


def offline_outputs(
    spec: DetectorSpec, params: dict, x: torch.Tensor, method: str = "matmul"
) -> torch.Tensor:
    """Whole-signal detection: [n] samples -> [n_evals, outputs]."""
    f = num_frames(x.shape[0], spec.window_length, spec.window_overlap)
    feats = stack_features(_band(spec, x, f, method), spec.time_range)
    return detect_features(spec, params, feats)


def offline_outputs_batch(
    spec: DetectorSpec, params, xs: torch.Tensor, method: str = "matmul"
) -> torch.Tensor:
    """[C, n] streams -> [C, n_evals, outputs] through the unfused path:
    ``params`` is one shared net or a sequence of C nets of one geometry,
    vmapped over channels."""
    if isinstance(params, (list, tuple)):
        if len(params) != xs.shape[0]:
            raise ValueError(
                f"{len(params)} per-channel networks for {xs.shape[0]} channels"
            )
        return torch.func.vmap(
            lambda p, x: offline_outputs(spec, p, x, method)
        )(stack_params(list(params)), xs)
    return torch.func.vmap(lambda x: offline_outputs(spec, params, x, method))(xs)


def streaming_init(
    spec: DetectorSpec, prefix: torch.Tensor | None = None, device="cuda"
) -> dict:
    """Initial streaming carry on ``device`` (on ``prefix``'s device when one
    is given).

    ``prefix`` must be the stream's first ``spec.residual`` samples (they
    prime the overlap window); pass None to start from zeros (outputs for
    the first ``time_range - 1`` frames are then warm-up garbage and the
    first ``residual`` samples are treated as zero).
    """
    r = spec.residual
    if prefix is not None:
        prefix = torch.as_tensor(prefix, dtype=torch.float32)
        if prefix.shape != (r,):
            raise ValueError(
                f"prefix must be the stream's first {r} samples "
                f"(spec.residual), got shape {tuple(prefix.shape)}"
            )
        device = prefix.device
        res = prefix
    else:
        res = torch.zeros(r, dtype=torch.float32, device=device)
    return {
        "residual": res,
        "history": torch.zeros(
            (spec.history, spec.n_bins), dtype=torch.float32, device=device
        ),
    }


def streaming_step(
    spec: DetectorSpec,
    params: dict,
    carry: dict,
    chunk: torch.Tensor,
    method: str = "matmul",
) -> tuple[dict, torch.Tensor]:
    """One fixed-shape step over a chunk of ``H * hop`` samples.

    Emits exactly H outputs (one per hop). Output h of the global stream's
    frame g is valid once g >= time_range - 1; the caller discards the
    warm-up rows, reproducing the reference's "first decision after
    window + hop*(timeRange-1) samples" accounting.
    """
    hop = spec.hop
    h_hops = chunk.shape[0] // hop
    if chunk.shape[0] != h_hops * hop:
        raise ValueError(
            f"chunk length {chunk.shape[0]} must be a multiple of the "
            f"hop ({hop})"
        )
    samples = torch.cat([carry["residual"], chunk])
    band = _band(spec, samples, h_hops, method)
    hist = torch.cat([carry["history"], band])  # [T-1+H, B]
    outs = detect_features(spec, params, stack_features(hist, spec.time_range))
    new_carry = {
        "residual": samples[h_hops * hop :],
        "history": hist[h_hops:],
    }
    return new_carry, outs


def streaming_scan(
    spec: DetectorSpec,
    params: dict,
    x: torch.Tensor,
    chunk_hops: int = 16,
    method: str = "matmul",
) -> torch.Tensor:
    """Run a whole stream through :func:`streaming_step`, chunk after chunk
    -> [n_evals, outputs].

    Numerically identical to :func:`offline_outputs` (the first
    ``spec.residual`` samples prime the carry; warm-up rows are dropped).
    The JAX package scans on the device; here the loop over chunks is
    Python's.
    """
    r = spec.residual
    step_len = chunk_hops * spec.hop
    n = x.shape[0]
    # zero-pad the tail to a whole number of chunks; each evaluation depends
    # only on its own sample window, so the padded ones are sliced away below
    n_chunks = -(-(n - r) // step_len) if n > r else 0
    usable = r + n_chunks * step_len
    if usable > n:
        x = torch.cat([x, x.new_zeros(usable - n)])
    carry = streaming_init(spec, prefix=x[:r])
    outs = []
    for chunk in x[r:usable].reshape(n_chunks, step_len):
        carry, o = streaming_step(spec, params, carry, chunk, method=method)
        outs.append(o)
    f = num_frames(n, spec.window_length, spec.window_overlap)
    n_evals = max(0, f - spec.time_range + 1)
    if not outs:
        return x.new_zeros((0, spec.net.outputs))
    return torch.cat(outs)[spec.history : spec.history + n_evals]


def deinterleave_frames(
    samples: np.ndarray, rem: np.ndarray, channels: int
) -> tuple[np.ndarray, np.ndarray]:
    """Split a frame-major interleaved capture buffer into whole
    ``[n, channels]`` frames plus the trailing PARTIAL frame (to carry
    into the next call). Shared by :meth:`Detector.append_interleaved_data`
    and ``DetectorBank.append_interleaved_audio_data`` so the carry
    semantics cannot drift between them."""
    flat = np.asarray(samples, np.float32).reshape(-1)
    if len(rem):
        flat = np.concatenate([rem, flat])
    n = len(flat) // channels
    return (
        flat[: n * channels].reshape(n, channels),
        flat[n * channels :].copy(),
    )


class Detector:
    """Host-side streaming detector with the reference's semantics.

    appendAudioData / processNewValue / lastOutputs / lastDetected /
    seenSyllable, except that ``drain()`` returns *all* newly available
    outputs as an array instead of looping one hop per call. Buffered
    samples stay on the host; each drain step moves what it evaluates to
    ``device``.
    """

    def __init__(
        self, cfg: SyllableDetectorConfig, method: str = "matmul", device="cuda"
    ):
        from syllable_detector_tpu_torch.kernels import fused_detector

        self.config = cfg
        self.device = torch.device(device)
        self.spec, self.params = detector_spec_from_config(cfg, self.device)
        if method not in ("matmul", "rfft", "fused"):
            raise ValueError(f"unknown method {method!r}")
        if method == "fused" and not fused_detector.fusable(self.spec):
            method = "matmul"  # routed by spec, as the JAX package routes it
        self.method = method
        self._folded = (
            fused_detector.fold_constants(self.spec, self.params, self.device)
            if method == "fused"
            else None
        )
        self._residual = np.zeros(0, np.float32)
        self._history = self._zero_history()
        self._frames_seen = 0  # global frame counter (for warm-up discard)
        self.last_outputs = np.zeros(self.spec.net.outputs, np.float32)
        # trailing partial interleaved frame awaiting the next capture chunk
        # (append_interleaved_data), and the channel count it was cut for
        self._interleave_rem = np.zeros(0, np.float32)
        self._interleave_channels = None

    def _zero_history(self) -> torch.Tensor:
        return torch.zeros(
            (self.spec.history, self.spec.n_bins),
            dtype=torch.float32,
            device=self.device,
        )

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.spec.net.outputs), np.float32)

    @property
    def last_detected(self) -> bool:
        # lastOutputs[0] >= thresholds[0]
        return bool(float(self.last_outputs[0]) >= self.spec.thresholds[0])

    def append_audio_data(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._residual = np.concatenate([self._residual, samples])

    def append_interleaved_data(
        self, samples: np.ndarray, channels: int, channel: int = 0
    ) -> None:
        """Append ONE channel's samples out of a frame-major interleaved
        capture buffer ([s0c0, s0c1, ..., s1c0, ...]). A trailing PARTIAL
        frame is kept and prepended to the next call with the same
        ``channels``; a call with another ``channels`` drops it (the framing
        changed)."""
        if not 0 <= channel < channels:
            raise ValueError(f"channel {channel} out of range 0..{channels - 1}")
        rem = (
            self._interleave_rem
            if self._interleave_channels == channels
            else np.zeros(0, np.float32)
        )
        frames, self._interleave_rem = deinterleave_frames(samples, rem, channels)
        self._interleave_channels = channels
        self.append_audio_data(np.ascontiguousarray(frames[:, channel]))

    def drain(self) -> np.ndarray:
        """Process all buffered hops; returns [n_new, outputs] (may be empty).

        The first timeRange-1 frames of the stream produce no output, as in
        the reference's "wait until the feature ring holds timeRange frames"
        rule.
        """
        if self.method == "fused":
            return self._drain_fused()
        spec = self.spec
        outs = []
        while num_frames(
            len(self._residual), spec.window_length, spec.window_overlap
        ):
            outs.append(self._drain_up_to(MAX_DRAIN_FRAMES))
        return np.concatenate(outs, axis=0) if outs else self._empty()

    def _drain_up_to(self, f_max: int) -> np.ndarray:
        """One unfused drain step over at most ``f_max`` frames, carrying the
        last timeRange-1 band frames as history into the next step."""
        spec = self.spec
        buf = self._residual
        f = min(num_frames(len(buf), spec.window_length, spec.window_overlap), f_max)
        gap, _ = normalize_overlap(spec.window_overlap)
        need = (f - 1) * spec.hop + gap + spec.window_length
        samples = torch.from_numpy(buf[:need]).to(self.device)
        band = _band(spec, samples, f, self.method)
        hist = torch.cat([self._history, band])  # [T-1+f, B]
        outs = detect_features(
            spec, self.params, stack_features(hist, spec.time_range)
        )
        self._history = hist[f:].clone()
        self._residual = buf[f * spec.hop :]
        outs = outs.cpu().numpy()
        # discard stream warm-up rows (frames before timeRange-1)
        skip = max(0, spec.history - self._frames_seen)
        self._frames_seen += f
        outs = outs[skip:]
        if len(outs):
            self.last_outputs = outs[-1]
        return outs

    def _drain_fused(self) -> np.ndarray:
        """Drain through the fused kernel.

        The kernel consumes raw samples and needs timeRange frames of context
        per evaluation, so instead of carrying band-frame history the buffer
        keeps the last timeRange-1 hops of *samples* after each step: the
        next drain's evaluations start exactly where this one stopped.
        """
        from syllable_detector_tpu_torch.kernels.fused_detector import (
            fused_offline_outputs,
        )

        spec = self.spec
        t = spec.time_range
        hop = spec.hop
        gap, _ = normalize_overlap(spec.window_overlap)
        buf = self._residual
        f = num_frames(len(buf), spec.window_length, spec.window_overlap)
        n_new = f - (t - 1)
        chunks = []
        while n_new > 0:
            take = min(n_new, MAX_DRAIN_FRAMES)
            # samples for `take` evals = take + t - 1 frames
            need = (take + t - 2) * hop + gap + spec.window_length
            samples = torch.from_numpy(buf[:need]).to(self.device)
            outs = fused_offline_outputs(
                spec, self.params, samples, folded=self._folded
            )
            chunks.append(outs.cpu().numpy())
            buf = buf[take * hop :]
            n_new -= take
        if not chunks:
            return self._empty()
        self._residual = buf
        outs = np.concatenate(chunks, axis=0)
        self._frames_seen += len(outs)
        self.last_outputs = outs[-1]
        return outs

    def note_gap(self, n: int = 0) -> None:
        """Register a capture discontinuity (``n`` samples lost): windows
        must never straddle missing audio, so the streaming state resets and
        the stream re-warms on the far side exactly like a fresh one.
        Evaluable pre-gap hops still buffered are DISCARDED — call
        :meth:`drain` first to flush them."""
        self._residual = np.zeros(0, np.float32)
        self._history = self._zero_history()
        self._frames_seen = 0
        # a pending partial interleaved frame is pre-gap audio too
        self._interleave_rem = np.zeros(0, np.float32)

    def warm_up(self, buckets: tuple = _FRAME_BUCKETS) -> int:
        """Run one drain step of each bucket's shape on zeros, so that the
        first live drain pays for no build: on a card the fused kernel is
        compiled and loaded by the first of them. Returns the number of
        shapes run."""
        from syllable_detector_tpu_torch.kernels.fused_detector import (
            fused_offline_outputs,
        )

        spec = self.spec
        gap, _ = normalize_overlap(spec.window_overlap)
        for b in buckets:
            # the samples of b evaluations: b + T - 1 frames
            need = (b + spec.time_range - 2) * spec.hop + gap + spec.window_length
            x = torch.zeros(need, dtype=torch.float32, device=self.device)
            if self.method == "fused":
                fused_offline_outputs(spec, self.params, x, folded=self._folded)
            else:
                offline_outputs(spec, self.params, x, self.method)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(buckets)

    def seen_syllable(self) -> bool:
        """Drain and OR detections on output 0."""
        outs = self.drain()
        if not len(outs):
            return False
        return bool(np.any(outs[:, 0] >= np.float32(self.spec.thresholds[0])))

    def get_state(self) -> dict:
        """Snapshot the streaming state as plain numpy arrays, in the JAX
        package's ``Detector.get_state`` format (``interleave_channels`` 0
        means no interleaved append yet)."""
        return {
            "residual": self._residual.copy(),
            "history": self._history.cpu().numpy().copy(),
            "frames_seen": int(self._frames_seen),
            "last_outputs": np.asarray(self.last_outputs, np.float32).copy(),
            "interleave_rem": self._interleave_rem.copy(),
            "interleave_channels": int(self._interleave_channels or 0),
        }

    def set_state(self, state: dict) -> None:
        """Restore a snapshot taken by :meth:`get_state` here or by the JAX
        package's ``Detector.get_state``; continuing the stream afterwards
        produces the outputs an uninterrupted detector would."""
        history = np.asarray(state["history"], np.float32)
        if history.shape != (self.spec.history, self.spec.n_bins):
            raise ValueError(
                f"state history shape {history.shape} does not match this "
                f"detector ({self.spec.history}, {self.spec.n_bins})"
            )
        self._residual = np.asarray(state["residual"], np.float32).copy()
        self._history = torch.from_numpy(history.copy()).to(self.device)
        self._frames_seen = int(state["frames_seen"])
        self.last_outputs = np.asarray(state["last_outputs"], np.float32).copy()
        self._interleave_rem = np.asarray(
            state.get("interleave_rem", np.zeros(0, np.float32)), np.float32
        ).copy()
        ich = int(state.get("interleave_channels", 0))
        self._interleave_channels = ich if ich > 0 else None

    def save_state(self, path) -> None:
        """Write :meth:`get_state` to ``path`` as an ``.npz`` file, the JAX
        package's ``Detector.save_state`` format."""
        np.savez(path, **self.get_state())

    def load_state(self, path) -> None:
        """Restore a state file written by :meth:`save_state` here or by the
        JAX package's ``Detector.save_state``."""
        with np.load(path) as data:
            self.set_state({k: data[k] for k in data.files})
