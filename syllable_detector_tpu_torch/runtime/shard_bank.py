"""Lane-sharded multi-process DetectorBank: the live host pipeline over
more than one CPU core.

Counterpart of ``syllable_detector_tpu.runtime.shard_bank``. One process's
host work caps the live lane count: at 256 lanes a ``bank.drain()`` round is
8.6 ms of host time, 71 % of it staging, and 512 lanes are not sustained
(PERF.md §5). This module splits that work:

* **Workers** (one process per contiguous shard of lanes) own everything
  host-bound: segment accounting, gap splicing, drain staging (the native
  quantise-and-assemble call), exactly the per-lane algebra of
  :class:`~syllable_detector_tpu_torch.models.detector_bank.DetectorBank`,
  which they subclass. A worker's bank lives on the CPU and stages straight
  into its shared-memory request arena; it never initialises CUDA.
* **The parent** owns the card and runs a device-server thread: each staged
  ``[c_w, need]`` wire round is read from the worker's arena, evaluated by
  the same drain the single-process bank runs (``fused_batch_program``,
  one launch; the matmul route included, because the server delegates to a
  real eval-only ``DetectorBank`` per shard), and the ``[c_w, n_evals,
  outputs]`` block returns through the shard's response arena.

Transport is ``multiprocessing.shared_memory`` plus queues: one request and
one response arena per worker (sized for the largest drain bucket), a shared
request queue into the server and a queue of replies per worker. On a card
the request arenas are registered as pinned memory, so the upload of a round
is one asynchronous copy straight from the arena. Processes start with the
``spawn`` method.
"""

from __future__ import annotations

import contextlib
import queue as queue_mod
import threading
import traceback
from multiprocessing import get_context
from multiprocessing import shared_memory as shm_mod

import numpy as np
import torch

from syllable_detector_tpu_torch.models.detector import detector_spec_from_config
from syllable_detector_tpu_torch.models.detector_bank import DetectorBank
from syllable_detector_tpu_torch.ops.stft import normalize_overlap, num_frames

__all__ = ["ShardedDetectorBank", "WireDeviceServer"]

# live deployments pin one drain bucket (one drain shape)
_DEFAULT_BUCKETS = (128,)

_WIRE_NP = {"float32": np.float32, "int16": np.int16, "mulaw8": np.int8}


def _drain_geometry(spec, buckets) -> dict[int, int]:
    """{need: n_evals} for each drain bucket, the arithmetic of
    DetectorBank.drain, so that both sides of the wire agree on shapes."""
    t = spec.time_range
    hop = spec.hop
    gap, _ = normalize_overlap(spec.window_overlap)
    out = {}
    for b in buckets:
        need = (b + t - 2) * hop + gap + spec.window_length
        f = num_frames(need, spec.window_length, spec.window_overlap)
        out[need] = f - t + 1
    return out


def _attach_shm(name: str) -> shm_mod.SharedMemory:
    """Attach to an existing segment without letting this process's
    resource tracker adopt it: on Python 3.12 an attach registers the name,
    and the tracker would unlink the segment when the worker exits, under
    the parent and the other workers. Registration is suppressed during the
    attach, so the tracker never learns the name."""
    from multiprocessing import resource_tracker

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shm_mod.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class _DeviceLink:
    """Worker-side handle to the parent's device server."""

    def __init__(self, worker_id, req_buf, resp_view, req_q, resp_q):
        self.worker_id = worker_id
        self.req_buf = req_buf
        self.resp_view = resp_view
        self.req_q = req_q
        self.resp_q = resp_q


class _RemoteWireBank(DetectorBank):
    """A CPU DetectorBank whose device evaluation happens in another
    process. Everything host-side (segments, gaps, native staging, buckets,
    output bookkeeping) is inherited unchanged. The staging buffer of a
    round is the shared request arena itself, laid out as a contiguous
    ``[lanes, need]`` array, so nothing is copied on the way out; and
    ``_wire_outputs`` is a round trip to the parent's device server."""

    def __init__(self, configs, link: _DeviceLink, **kwargs):
        super().__init__(configs, device="cpu", **kwargs)
        self._link = link
        self._arena_need = None

    def _staging(self, need: int):
        entry = self._stage.get(need)
        if entry is None:
            xs = np.ndarray((self.n_lanes, need), _WIRE_NP[self.transfer_dtype],
                            buffer=self._link.req_buf)
            entry = self._stage[need] = (xs, torch.from_numpy(xs),
                                         np.full(self.n_lanes, need, np.int64))
        if need != self._arena_need:
            # another shape wrote the arena since: every row's tail is stale
            entry[2][:] = need
            self._arena_need = need
        return entry

    def _wire_outputs(self, xs: torch.Tensor) -> np.ndarray:
        link = self._link
        link.req_q.put((link.worker_id, xs.shape[1]))
        r = link.resp_q.get()
        if isinstance(r, tuple):  # ("err", text)
            raise RuntimeError(f"device server failed a drain round: {r[1]}")
        # copy out of the response arena: drain() keeps row views across
        # bucket rounds, and the next round overwrites the arena
        return link.resp_view[:, :r, :].copy()


def _worker_main(worker_id, configs, bank_kwargs, req_name, resp_name, resp_shape,
                 cmd_q, rep_q, req_q, devresp_q):
    """Worker process: run the shard's bank against the command stream. It
    never initialises CUDA: its bank lives on the CPU and only its staging
    buffers are shared."""
    req_shm = _attach_shm(req_name)
    resp_shm = _attach_shm(resp_name)
    try:
        resp_view = np.ndarray(resp_shape, np.float32, buffer=resp_shm.buf)
        link = _DeviceLink(worker_id, req_shm.buf, resp_view, req_q, devresp_q)
        bank = _RemoteWireBank(configs, link, **bank_kwargs)
        pending_err = None
        while True:
            msg = cmd_q.get()
            op = msg[0]
            if op == "stop":
                break
            try:
                if op == "append":
                    bank.append_audio_data(msg[1], msg[2])
                elif op == "gap":
                    bank.note_gap(msg[1], msg[2])
                elif op == "drain":
                    if pending_err is not None:
                        rep_q.put(("err", pending_err))
                        pending_err = None
                        continue
                    res = bank.drain(flush=msg[1])
                    valid = (
                        np.concatenate([res[i, : bank.last_counts[i]] for i in range(bank.n_lanes)])
                        if res.shape[1]
                        else np.zeros((0, res.shape[2]), np.float32)
                    )
                    rep_q.put(
                        (
                            "ok",
                            bank.last_counts.copy(),
                            [a.copy() for a in bank.last_sample_indices],
                            valid,
                            list(bank.overflows),
                            list(bank.dropped_samples),
                            list(bank.hops_emitted),
                        )
                    )
            except Exception:
                err = traceback.format_exc(limit=8)
                if op == "drain":
                    rep_q.put(("err", err))
                else:
                    # appends and gaps are fire-and-forget: the failure
                    # surfaces at the next drain
                    pending_err = err
    finally:
        # arrays over the segments may still be alive here; the segments
        # belong to the parent, which unlinks them
        for shm in (req_shm, resp_shm):
            with contextlib.suppress(BufferError):
                shm.close()


class WireDeviceServer:
    """The parent's device half of the sharded bank: owns the card, one
    shared-memory request/response arena pair per worker, and a server
    thread that evaluates staged ``[c_w, need]`` wire rounds through a real
    eval-only :class:`DetectorBank` per shard on ``device`` (so the drain
    program, the matmul route and the wire dequantisation are the
    single-process code). The server thread evaluates on one CUDA stream of
    its own, on the device it sets for itself.

    :meth:`warm_up` runs on the caller's thread: call it before
    :meth:`start`, never while the server thread serves."""

    def __init__(
        self,
        shard_configs,
        method: str = "fused",
        buckets: tuple = _DEFAULT_BUCKETS,
        transfer_dtype: str = "float32",
        min_drain_hops: int = 1,
        ctx=None,
        device="cuda",
    ):
        if transfer_dtype not in _WIRE_NP:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {device!r} was asked for and no CUDA device is available")
            if self.device.index is None:
                # the server thread sets its device by index
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.ctx = ctx if ctx is not None else get_context("spawn")
        self.wire = transfer_dtype
        self.n_workers = len(shard_configs)
        self.spec = detector_spec_from_config(shard_configs[0][0], "cpu")[0]
        out_w = self.spec.net.outputs
        geom = _drain_geometry(self.spec, buckets)
        need_max = max(geom)
        ne_max = max(geom.values())
        self.itemsize = np.dtype(_WIRE_NP[transfer_dtype]).itemsize
        self.req_q = self.ctx.Queue()
        self.resp_qs = [self.ctx.Queue() for _ in range(self.n_workers)]
        self._shms: list[shm_mod.SharedMemory] = []
        self._registered: list[int] = []
        self._req_flat: list[np.ndarray] = []
        self.resp_views: list[np.ndarray] = []
        self.link_specs = []  # per worker: what its process needs to attach
        self.banks = []
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        try:
            for cfgs_w in shard_configs:
                c = len(cfgs_w)
                req = shm_mod.SharedMemory(create=True, size=max(1, c * need_max * self.itemsize))
                resp = shm_mod.SharedMemory(create=True, size=max(1, c * ne_max * out_w * 4))
                self._shms += [req, resp]
                flat = np.ndarray((req.size,), np.uint8, buffer=req.buf)
                self._req_flat.append(flat)
                if self.device.type == "cuda":
                    self._register(flat)
                resp_shape = (c, ne_max, out_w)
                self.resp_views.append(np.ndarray(resp_shape, np.float32, buffer=resp.buf))
                self.link_specs.append((req.name, resp.name, resp_shape))
                self.banks.append(
                    DetectorBank(
                        list(cfgs_w),
                        method=method,
                        buckets=buckets,
                        transfer_dtype=transfer_dtype,
                        min_drain_hops=min_drain_hops,
                        device=self.device,
                    )
                )
        except Exception:
            self.stop()
            raise
        self._thread = None

    def _register(self, flat: np.ndarray) -> None:
        """Pin an arena (cudaHostRegister), so a round's upload is one
        asynchronous copy from it."""
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(flat.ctypes.data, flat.nbytes, 0))
        self._registered.append(flat.ctypes.data)

    def request(self, w: int, need: int) -> torch.Tensor:
        """Worker ``w``'s staged round of ``need`` samples per lane: a
        ``[c_w, need]`` tensor over its request arena."""
        c = self.banks[w].n_lanes
        xs = self._req_flat[w][: c * need * self.itemsize].view(_WIRE_NP[self.wire])
        return torch.from_numpy(xs.reshape(c, need))

    def _evaluate(self, w: int, need: int) -> int:
        """Evaluate worker ``w``'s staged round into its response arena;
        returns the evaluations per lane."""
        out = self.banks[w]._wire_outputs(self.request(w, need))
        ne = out.shape[1]
        self.resp_views[w][:, :ne, :] = out
        return ne

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def start(self):
        self._thread = threading.Thread(
            target=self._serve, name="shard-bank-device-server", daemon=True
        )
        self._thread.start()
        return self

    def _serve(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with self._on_stream():
            while True:
                msg = self.req_q.get()
                if msg is None:
                    return
                w, need = msg
                try:
                    self.resp_qs[w].put(self._evaluate(w, need))
                except Exception:
                    self.resp_qs[w].put(("err", traceback.format_exc(limit=8)))

    @property
    def started(self) -> bool:
        return self._thread is not None

    @property
    def serving(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def warm_up(self) -> int:
        """Run every drain-bucket round of every shard once on zeros (builds
        and loads the kernel, folds each shard's nets); returns the number
        of rounds. Runs on the caller's thread, so call it before
        :meth:`start`."""
        if self.started:
            raise RuntimeError("warm_up runs before the server thread starts")
        n = 0
        with self._on_stream():
            for w, bank in enumerate(self.banks):
                for need in _drain_geometry(self.spec, bank._buckets):
                    self.request(w, need).zero_()
                    self._evaluate(w, need)
                    n += 1
            if self._stream is not None:
                self._stream.synchronize()
        return n

    def stop(self):
        if getattr(self, "_thread", None) is not None and self._thread.is_alive():
            self.req_q.put(None)
            self._thread.join(timeout=10)
        self._thread = None
        if getattr(self, "_stream", None) is not None:
            self._stream.synchronize()
        for ptr in getattr(self, "_registered", []):
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))
        self._registered = []
        self._req_flat = []
        self.resp_views = []
        for shm in getattr(self, "_shms", []):
            with contextlib.suppress(BufferError):
                shm.close()
            with contextlib.suppress(FileNotFoundError):
                shm.unlink()
        self._shms = []


class ShardedDetectorBank:
    """Multi-process variant of :class:`DetectorBank`: lanes are sharded
    contiguously over ``n_workers`` processes that do all host-side
    staging, while this process evaluates every staged round on
    ``device``. Same drain contract: ``drain()`` returns ``[n_lanes, n_max,
    outputs]`` with ``last_counts`` / ``last_sample_indices`` valid
    prefixes, gap and overflow accounting aggregate per lane, and results
    equal a single-process ``DetectorBank`` fed the same stream (the
    staging, the bucket ladder and the drain program are the same code on
    both sides).

    The server thread starts at the first drain; :meth:`warm_up` runs
    before it. A failed drain raises only after every worker's reply for
    that round has been read, so the next round stays aligned. Not
    thread-safe; drive from one thread.
    """

    def __init__(
        self,
        configs,
        n_workers: int = 2,
        method: str = "fused",
        max_buffer_seconds: float = 30.0,
        buckets: tuple | None = None,
        transfer_dtype: str = "float32",
        min_drain_hops: int = 1,
        device="cuda",
    ):
        if n_workers < 1 or n_workers > len(configs):
            raise ValueError(
                f"n_workers must be in [1, n_lanes]; got {n_workers} for {len(configs)} lanes"
            )
        if transfer_dtype not in _WIRE_NP:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        buckets = tuple(buckets) if buckets is not None else _DEFAULT_BUCKETS
        self.n_lanes = len(configs)
        self.spec = detector_spec_from_config(configs[0], "cpu")[0]
        self.thresholds = np.asarray([c.thresholds[0] for c in configs], np.float64)
        out_w = self.spec.net.outputs

        base, extra = divmod(self.n_lanes, n_workers)
        sizes = [base + (1 if w < extra else 0) for w in range(n_workers)]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.n_workers = n_workers

        self._closed = False
        shard_cfgs = [
            list(configs[self._offsets[w] : self._offsets[w + 1]]) for w in range(n_workers)
        ]
        self._server = WireDeviceServer(
            shard_cfgs,
            method=method,
            buckets=buckets,
            transfer_dtype=transfer_dtype,
            min_drain_hops=min_drain_hops,
            device=device,
        )
        ctx = self._server.ctx
        self._cmd_qs = [ctx.Queue() for _ in range(n_workers)]
        self._rep_qs = [ctx.Queue() for _ in range(n_workers)]
        self._workers = []
        bank_kwargs = dict(
            method=method,
            max_buffer_seconds=max_buffer_seconds,
            buckets=buckets,
            transfer_dtype=transfer_dtype,
            min_drain_hops=min_drain_hops,
        )
        try:
            for w in range(n_workers):
                req_name, resp_name, resp_shape = self._server.link_specs[w]
                p = ctx.Process(
                    target=_worker_main,
                    args=(w, shard_cfgs[w], bank_kwargs, req_name, resp_name, resp_shape,
                          self._cmd_qs[w], self._rep_qs[w], self._server.req_q,
                          self._server.resp_qs[w]),
                    daemon=True,
                )
                p.start()
                self._workers.append(p)
        except Exception:
            self.close()
            raise

        self.last_counts = np.zeros(self.n_lanes, np.int64)
        self.last_sample_indices = [np.zeros(0, np.int64) for _ in range(self.n_lanes)]
        self.last_outputs = np.zeros((self.n_lanes, out_w), np.float32)
        self.overflows = [0] * self.n_lanes
        self.dropped_samples = [0] * self.n_lanes
        self.hops_emitted = [0] * self.n_lanes

    @property
    def worker_pids(self) -> list[int]:
        return [p.pid for p in self._workers]

    def warm_up(self) -> int:
        """Run every drain-bucket round once per shard on the card (builds
        and loads the kernel) before the first drain; returns the rounds
        run. Raises once draining has started."""
        return self._server.warm_up()

    # -- feeding (routed to the owning worker) ---------------------------

    def _worker_of(self, lane: int) -> tuple[int, int]:
        if not 0 <= lane < self.n_lanes:
            raise IndexError(f"lane {lane} out of range")
        w = int(np.searchsorted(self._offsets, lane, side="right") - 1)
        return w, lane - int(self._offsets[w])

    def append_audio_data(self, lane: int, samples: np.ndarray) -> None:
        """Queue samples for one lane (they ship to the shard's worker,
        whose bank applies the buffer cap). Unlike DetectorBank this returns
        nothing: overflow totals aggregate at each drain."""
        w, local = self._worker_of(lane)
        self._cmd_qs[w].put(("append", local, np.ascontiguousarray(samples, np.float32)))

    def note_gap(self, lane: int, n: int) -> None:
        w, local = self._worker_of(lane)
        self._cmd_qs[w].put(("gap", local, int(n)))

    # -- draining ---------------------------------------------------------

    def drain(self, flush: bool = False) -> np.ndarray:
        """Broadcast a drain to every worker (their staging overlaps across
        processes), serve their rounds, and assemble the ``[n_lanes, n_max,
        outputs]`` result and valid-prefix metadata as DetectorBank.drain
        does. Every worker's reply is read before a failure raises."""
        if self._closed:
            raise RuntimeError("bank is closed")
        if not self._server.started:
            self._server.start()
        for q in self._cmd_qs:
            q.put(("drain", flush))
        replies = [self._get_reply(w) for w in range(self.n_workers)]
        failed = [(w, r[1]) for w, r in enumerate(replies) if r[0] == "err"]
        if failed:
            raise RuntimeError(
                "\n".join(f"worker {w} drain failed:\n{err}" for w, err in failed)
            )
        counts = np.zeros(self.n_lanes, np.int64)
        for w, (_, c_w, idx_w, _valid, ovf, drp, hops) in enumerate(replies):
            lo = int(self._offsets[w])
            counts[lo : lo + len(c_w)] = c_w
            for i, a in enumerate(idx_w):
                self.last_sample_indices[lo + i] = a
            self.overflows[lo : lo + len(ovf)] = ovf
            self.dropped_samples[lo : lo + len(drp)] = drp
            self.hops_emitted[lo : lo + len(hops)] = hops
        n_out = int(counts.max()) if self.n_lanes else 0
        result = np.zeros((self.n_lanes, n_out, self.spec.net.outputs), np.float32)
        for w, (_, c_w, _idx, valid_w, *_rest) in enumerate(replies):
            lo = int(self._offsets[w])
            pos = 0
            for i, c in enumerate(c_w):
                if c:
                    result[lo + i, :c] = valid_w[pos : pos + c]
                    self.last_outputs[lo + i] = valid_w[pos + c - 1]
                    pos += c
        self.last_counts = counts
        return result

    def _get_reply(self, w: int):
        """Worker ``w``'s reply to the current drain; a worker that died, or a
        device server that stopped (no reply will come), counts as a failed
        reply."""
        while True:
            try:
                return self._rep_qs[w].get(timeout=1.0)
            except queue_mod.Empty:
                if not self._workers[w].is_alive():
                    return ("err", f"worker {w} died (exitcode {self._workers[w].exitcode}) mid-drain")
                if not self._server.serving:
                    return ("err", "the device server thread stopped")

    def seen_syllables(self) -> np.ndarray:
        """Drain and OR detections per lane (DetectorBank.seen_syllables)."""
        outs = self.drain()
        if not outs.shape[1]:
            return np.zeros(self.n_lanes, bool)
        valid = np.arange(outs.shape[1])[None, :] < self.last_counts[:, None]
        hits = outs[:, :, 0] >= self.thresholds.astype(np.float32)[:, None]
        return np.any(hits & valid, axis=1)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if getattr(self, "_closed", True):
            return
        self._closed = True
        for q in getattr(self, "_cmd_qs", []):
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in getattr(self, "_workers", []):
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        if getattr(self, "_server", None) is not None:
            self._server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
