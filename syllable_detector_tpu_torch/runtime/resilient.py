"""Process-isolated streaming detection with automatic crash recovery.

Counterpart of ``syllable_detector_tpu.runtime.resilient``. On a card a
sticky CUDA error (an illegal address, a launch that faults) poisons the
process's context: every later call fails until the process exits. The
reference's answer is "restart the app"; for a closed-loop experiment that
loses the session.

:class:`ResilientDetector` keeps the device work in a CHILD process and
supervises it:

  * the child hosts a :class:`~syllable_detector_tpu_torch.models.
    detector_bank.DetectorBank` (1..N lanes, distinct nets supported) on
    ``device`` and serves append/drain/warm_up requests over a pipe;
  * after every successful drain the child returns its post-drain state
    snapshot (``get_state``), which the parent retains;
  * audio appended since the last snapshot is journaled in the parent; if
    the child dies (a crash, a poisoned context, a timeout), the parent
    spawns a FRESH process, restores the snapshot, replays the journal and
    retries: the output stream continues exactly where it stopped.

The parent never touches the card, so the children own it; it only imports
torch. A child is started with the ``spawn`` method, so it gets a context
of its own; spawn re-imports the parent's ``__main__``, so construct a
ResilientDetector from an importable script or module. A child that finds
no card for ``device="cuda"`` fails its handshake (it never moves to the
CPU). Its first drain loads the built kernel library (``kernels/_build``
builds it once per source into ``build/torch_kernels/``); that time counts
against ``timeout`` like any request.
"""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np

__all__ = ["ResilientDetector", "DetectorChildError", "DetectorChildCrash"]


class DetectorChildError(RuntimeError):
    """A SEMANTIC error from the child (bad argument, bad state): the
    request is wrong, not the process, so a respawn would replay the same
    failure. The supervisor re-raises it at once without a restart; the
    child stays alive and keeps serving."""


class DetectorChildCrash(RuntimeError):
    """A crash-class child failure (a CUDA error, out of memory, any other
    unexpected exception, a dead pipe): the process is suspect, and the
    supervisor restarts it with snapshot and journal replay."""


# request errors of these types are semantic (caller mistakes), not a
# poisoned process: the child reports them and keeps serving. Everything
# else, torch's CUDA errors (RuntimeError, torch.OutOfMemoryError) among
# them, ends the child.
_SEMANTIC_ERRORS = (ValueError, TypeError, KeyError, IndexError)


def _child_main(conn, net_texts, method, device, max_buffer_seconds=30.0):
    """Child process: build the bank on ``device``, serve requests until
    EOF or stop."""
    try:
        import torch

        from syllable_detector_tpu_torch.config.model_format import loads_config
        from syllable_detector_tpu_torch.models.detector_bank import DetectorBank

        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} was asked for and no CUDA device is available")
        bank = DetectorBank(
            [loads_config(t) for t in net_texts],
            method=method,
            max_buffer_seconds=max_buffer_seconds,
            device=device,
        )
        conn.send(("ready", os.getpid()))
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            op = msg[0]
            if op == "stop":
                conn.send(("ok", None))
                return
            if op == "crash":  # test hook: simulate a poisoned process
                os._exit(17)
            try:
                if op == "append":
                    _, lane, samples = msg
                    bank.append_audio_data(lane, samples)
                    conn.send(("ok", None))
                elif op == "note_gap":
                    _, lane, n = msg
                    bank.note_gap(lane, n)
                    conn.send(("ok", None))
                elif op == "drain":
                    outs = bank.drain()
                    conn.send(
                        (
                            "ok",
                            (
                                outs,
                                bank.last_counts,
                                list(bank.last_sample_indices),
                                bank.get_state(),
                            ),
                        )
                    )
                elif op == "warm_up":
                    n = bank.warm_up(buckets=msg[1])
                    conn.send(("ok", (n, bank.get_state())))
                elif op == "set_state":
                    bank.set_state(msg[1])
                    conn.send(("ok", None))
                elif op == "launches":
                    conn.send(("ok", _kernel_launches()))
                else:
                    conn.send(("error", f"unknown op {op!r}"))
            except _SEMANTIC_ERRORS as e:
                conn.send(("error", f"{type(e).__name__}: {e}"))
    except Exception as e:  # construction or serve crashes: the process is suspect
        try:
            conn.send(("fatal", f"{type(e).__name__}: {e}"))
        except Exception:
            pass
        os._exit(1)


def _kernel_launches() -> dict:
    """This process's launches of the fused kernels, by entry: ``single``
    (K1a), ``batch`` (K1e, the float32 wire) and ``program <wire>`` (K1f)."""
    from syllable_detector_tpu_torch.kernels import fused_detector as fused

    return {
        "single": fused.LAUNCHES,
        "batch": fused.BATCH_LAUNCHES,
        **{f"program {wire}": n for wire, n in fused.PROGRAM_LAUNCHES.items()},
    }


class ResilientDetector:
    """Supervised multi-lane streaming detector (crash-isolated device work).

    ``configs``: one or more SyllableDetectorConfig (distinct nets per lane,
    as DetectorBank takes them). ``device`` is where the child's bank runs
    (default ``"cuda"``; ``"cpu"`` runs the kernels' plain versions).
    ``timeout`` bounds each request, the child's start and its first
    kernel library load included.
    """

    def __init__(
        self,
        configs,
        method: str = "fused",
        max_restarts: int = 3,
        timeout: float = 900.0,
        device: str = "cuda",
        max_buffer_seconds: float = 30.0,
    ):
        from syllable_detector_tpu_torch.config.model_format import dumps_config

        if not isinstance(configs, (list, tuple)):
            configs = [configs]
        self._net_texts = [dumps_config(c) for c in configs]
        self.n_lanes = len(configs)
        self.method = method
        self.max_restarts = max_restarts
        self.timeout = timeout
        self.device = str(device)
        # the parent mirrors the child bank's buffer cap: appends the bank
        # would drop are journaled as compact gap markers, so the replay
        # journal is bounded by the bank's own cap per lane
        self.max_buffer_seconds = max_buffer_seconds
        self._max_buffer_samples = int(max_buffer_seconds * configs[0].sampling_rate)
        # per-lane mirror of the child bank's buffered sample count, exact
        # between drains (the bank only trims inside drain and warm_up, and
        # both refresh the snapshot)
        self._buffered = [0] * self.n_lanes
        self.restarts = 0
        self.child_pid = None
        self.last_counts = np.zeros(self.n_lanes, np.int64)
        self.last_sample_indices = [np.zeros(0, np.int64) for _ in range(self.n_lanes)]
        self._snapshot = None  # last known-good post-drain state
        # appends since the snapshot: ("append", lane, samples) for chunks
        # the bank accepts, ("gap", lane, n) for chunks its cap drops
        self._journal: list[tuple] = []
        # per-lane index of the lane's trailing gap marker in _journal, so
        # that consecutive drops coalesce in O(1)
        self._gap_idx: list = [None] * self.n_lanes
        # trailing partial interleaved frame (parent-side de-interleave);
        # crash replay never sees it
        self._interleave_rem = np.zeros(0, np.float32)
        self._ctx = mp.get_context("spawn")
        self._proc = None
        self._conn = None
        self._start_child()

    # -- supervision --------------------------------------------------------

    def _start_child(self) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_child_main,
            args=(child_conn, self._net_texts, self.method, self.device, self.max_buffer_seconds),
            daemon=True,
        )
        self._proc.start()
        child_conn.close()
        self._conn = parent_conn
        try:
            status, payload = self._recv()
            if status != "ready":
                raise RuntimeError(f"detector child failed to start: {payload}")
            self.child_pid = payload
            if self._snapshot is not None:
                self._request(("set_state", self._snapshot))
            for entry in self._journal:
                if entry[0] == "gap":
                    self._request(("note_gap", entry[1], entry[2]))
                else:
                    self._request(("append", entry[1], entry[2]))
        except DetectorChildError:
            raise  # semantic replay failure: the child is alive and sane
        except Exception:
            # a failed or hung handshake must not leak the child: when this
            # escapes __init__ no instance exists and close() never runs,
            # and a live child would keep its context on the card
            self._kill_child()
            raise

    def _recv(self):
        if not self._conn.poll(self.timeout):
            raise TimeoutError(f"detector child unresponsive for {self.timeout}s")
        return self._conn.recv()

    def _request(self, msg):
        self._conn.send(msg)
        status, payload = self._recv()
        if status == "fatal":
            raise DetectorChildCrash(f"detector child failed: {payload}")
        if status == "error":
            raise DetectorChildError(payload)
        return payload

    def _supervised(self, msg, covered_by_replay: bool = False):
        """Send a request, restarting the child (snapshot + journal replay)
        on CRASH-CLASS failures only (dead pipe, timeout, unexpected child
        exception), up to ``max_restarts`` times. Semantic errors
        (:class:`DetectorChildError`) re-raise at once: a respawn would
        replay them.

        ``covered_by_replay``: the message's effect is already in the
        journal, so after a restart (whose replay applied it) it is not
        sent again, which would apply it twice.
        """
        attempts = 0
        while True:
            try:
                return self._request(msg)
            except DetectorChildError:
                raise
            except (EOFError, OSError, TimeoutError, DetectorChildCrash):
                self._kill_child()
                self.restarts += 1
                attempts += 1
                if attempts > self.max_restarts:
                    raise
                # the recovery (spawn, handshake, set_state, replay) can
                # crash too: keep it supervised
                while True:
                    try:
                        self._start_child()
                        break
                    except DetectorChildError:
                        raise
                    except Exception:
                        self._kill_child()
                        self.restarts += 1
                        attempts += 1
                        if attempts > self.max_restarts:
                            raise
                if covered_by_replay:
                    return None

    def _kill_child(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass
        if self._proc is not None:
            self._proc.terminate()
            self._proc.join(timeout=5)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=5)
            self._proc = None

    # -- detector API --------------------------------------------------------

    def append_audio_data(self, samples: np.ndarray, lane: int = 0) -> None:
        # own the data: a capture loop that reuses one buffer would rewrite
        # every journaled chunk, and a slice would pin its whole recording
        samples = np.array(samples, np.float32, copy=True).reshape(-1)
        n = len(samples)
        if self._buffered[lane] + n > self._max_buffer_samples:
            # the child bank would drop this chunk at its cap
            self.note_gap(lane, n)
            return
        # journal first: if the child dies handling this append, the
        # restart's replay applies it, and covered_by_replay skips the resend
        self._gap_idx[lane] = None
        self._journal.append(("append", lane, samples))
        self._buffered[lane] += n
        self._supervised(("append", lane, samples), covered_by_replay=True)

    def note_gap(self, lane: int, n: int) -> None:
        """Register ``n`` samples of the lane's stream as LOST (a buffer-cap
        drop or a capture gap). Journaled as a data-free marker; consecutive
        gaps on a lane coalesce into one marker, so a stalled drain loop
        does not grow the journal. Replay applies one note_gap with the
        summed ``n``: the stream clock and dropped-sample counts are the
        same; only the overflow event count merges."""
        gi = self._gap_idx[lane]
        if gi is not None:
            _, _, prev = self._journal[gi]
            self._journal[gi] = ("gap", lane, prev + n)
        else:
            self._gap_idx[lane] = len(self._journal)
            self._journal.append(("gap", lane, n))
        self._supervised(("note_gap", lane, n), covered_by_replay=True)

    def append_interleaved_audio_data(self, samples: np.ndarray) -> None:
        """Fan an interleaved ``n_lanes``-channel capture buffer out to the
        lanes (frame-major), carrying a trailing partial frame into the next
        call, as DetectorBank does. The de-interleave happens here, so the
        journal and crash replay see plain per-lane appends."""
        from syllable_detector_tpu_torch.models.detector import deinterleave_frames

        frames, self._interleave_rem = deinterleave_frames(
            samples, self._interleave_rem, self.n_lanes
        )
        for lane in range(self.n_lanes):
            self.append_audio_data(np.ascontiguousarray(frames[:, lane]), lane=lane)

    def note_interleaved_gap(self, n: int) -> None:
        """A gap of ``n`` interleaved samples on the stream feeding all
        lanes: every lane loses ``n // n_lanes`` samples, the pending partial
        frame is dropped and counted into the gaps of the lanes whose
        samples it held (DetectorBank.note_interleaved_gap)."""
        per_lane = n // self.n_lanes
        rem_len = len(self._interleave_rem)
        self._interleave_rem = np.zeros(0, np.float32)
        for lane in range(self.n_lanes):
            self.note_gap(lane, per_lane + (1 if lane < rem_len else 0))

    def drain(self) -> np.ndarray:
        outs, counts, sample_indices, state = self._supervised(("drain",))
        self.last_counts = counts
        self.last_sample_indices = sample_indices
        self._sync_snapshot(state)
        return outs

    def _sync_snapshot(self, state) -> None:
        self._snapshot = state
        self._journal.clear()
        self._gap_idx = [None] * self.n_lanes
        self._buffered = [sum(len(d) for _, d, _ in segs) for segs in state["segments"]]

    def warm_up(self, buckets=None) -> int:
        """Run every drain shape once in the child (builds or loads the
        kernel library); returns the number of shapes."""
        from syllable_detector_tpu_torch.models.detector import _FRAME_BUCKETS

        buckets = tuple(buckets) if buckets is not None else _FRAME_BUCKETS
        n, state = self._supervised(("warm_up", buckets))
        # the state already holds the journaled appends: keep snapshot and
        # journal consistent, or a crash would apply them twice
        self._sync_snapshot(state)
        return n

    def kernel_launches(self) -> dict:
        """The kernel launches of the serving child since it started (a
        respawned child counts from 0), by entry as the kernels count them:
        ``single``, ``batch``, ``program <wire>``. All 0 on the CPU, where
        the bank runs the kernels' plain versions."""
        return self._supervised(("launches",))

    def crash_for_test(self) -> None:
        """Make the child die abruptly (simulates a poisoned context)."""
        try:
            self._conn.send(("crash",))
        except Exception:
            pass
        if self._proc is not None:
            self._proc.join(timeout=10)

    def close(self) -> None:
        try:
            if self._proc is not None and self._proc.is_alive():
                self._conn.send(("stop",))
                self._conn.poll(5)
        except Exception:
            pass
        self._kill_child()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
