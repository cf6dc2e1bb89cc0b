"""Live traffic: an open loop of capture blocks into the port's ``Processor``.

Every lane hears its own seeded loop of S16-exact song (``loop_hops`` hops
long, so that each lane's outputs repeat with that period and the reference
computes one period), through its own seeded net. A paced source thread
delivers ``[lanes, block]`` float32 blocks on an absolute schedule (block
``b`` is due when its last sample has been captured, ``anchor + (b + 1) *
block / rate``), standing in for the ALSA reader thread. The ``Processor``
runs batched, on the fused method, the ``wire`` given, draining as soon as
work is queued.

A hop's latency runs from the due time of the block that carries its last
sample to the moment the ``Processor`` hands that round's decision for its
lane to the output backend (``prepare_output``; a lane the round does not
hand over is decided when the round's last hand-over is). The window holds
the hops of the blocks due in it, after ``preroll_s`` of traffic in set-up.
A hop not decided within ``grace_s`` of the window's end is failed and
counts as missing any limit.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time

import numpy as np
import torch

from benchmark import program, roofline, synth
from benchmark.reference import detect as ref


def _lane_audio(run, gen):
    """(float32 [P] S16-exact loop, float64 tensor of it) of one lane."""
    p = run.params
    period = p["loop_hops"] * roofline.hop(run.geom)
    codes = synth.to_s16(synth.chirp(period, run.geom["sampling_rate"], gen, run.device), 32767.0)
    x = codes.to(torch.float64) / 32767.0
    return x.to(torch.float32).cpu().numpy(), x


def reference_period(geom: dict, net: dict, x: torch.Tensor, hops: int, precision: str):
    """The first ``hops`` outputs of the loop ``x`` repeated: one period."""
    need = hops * roofline.hop(geom) + ref.first_output_sample(geom)
    reps = -(-need // len(x)) + 1
    return ref.outputs(geom, net, x.repeat(reps)[:need], precision)[:hops].cpu().numpy()


def setup(run):
    from syllable_detector_tpu_torch.runtime.audio_io import AudioInputInterface
    from syllable_detector_tpu_torch.runtime.processor import (
        OutputBackend,
        Processor,
        ProcessorEntry,
    )

    p, geom, device = run.params, run.geom, run.device
    gen = synth.generator(run.seed, device)
    loops, xs, nets, periods, thresholds = [], [], [], [], []
    for _ in range(p["lanes"]):
        loop, x = _lane_audio(run, gen)
        xs.append(x)
        net = synth.net(geom, gen, device)
        period = reference_period(geom, net, x, p["loop_hops"], "float64")
        loops.append(loop)
        nets.append(net)
        periods.append(period)
        thresholds.append(synth.pick_thresholds(period, p["margin"]))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    state = {"loops": np.stack(loops), "x": xs, "nets": nets, "periods": periods,
             "thresholds": thresholds}

    class Source(AudioInputInterface):
        def initialize_audio(self):
            pass

        def tear_down_audio(self):
            pass

    class Decisions(OutputBackend):
        """Stamps each lane's hand-over of the current round."""

        def prepare_output(self, index, entry, seen):
            state["stamp"](index)

    entries = [ProcessorEntry(input_channel=j, output_channel=j,
                              config=program.port_config(geom, nets[j], thresholds[j]))
               for j in range(p["lanes"])]
    proc = Processor(Source(), entries, Decisions(), ring_seconds=p["ring_seconds"],
                     batched=True, method="fused", bank_buffer_seconds=p["bank_buffer_seconds"],
                     bank_transfer_dtype=p["wire"], bank_min_drain_hops=1,
                     drain_interval=0.0, device=device)
    proc.warm_up(buckets=tuple(p["warm_buckets"]))
    state["processor"] = proc
    return state


class Recorder:
    """What each round decided, kept in arrays sized up front (the worker
    thread records a round without making objects that outlive it): for
    lane ``j`` and hop ``k``, its output, the round that decided it, and
    each round's hand-over time a lane."""

    def __init__(self, lanes: int, hops: int, rounds: int, first: int, step: int):
        self.first, self.step = first, step
        self.outs = np.full((lanes, hops), np.nan, np.float32)
        self.round_of = np.full((lanes, hops), -1, np.int64)
        self.times = np.full((rounds, lanes), np.nan)
        self.span = np.zeros((rounds, 2))
        self.stamps = np.full(lanes, np.nan)
        self.rounds = 0
        self.bad = 0  # hops at an index off the hop grid, or decided twice

    def drained(self, bank, out, t0: float, t1: float) -> None:
        """Record the round ``bank.drain`` just returned as ``out``."""
        self.close()
        r = self.rounds
        counts = bank.last_counts
        if counts.any():
            idx = np.concatenate(bank.last_sample_indices)
            lane = np.repeat(np.arange(len(counts)), counts)
            k, off = np.divmod(idx - self.first, self.step)
            ok = (off == 0) & (k >= 0) & (k < self.outs.shape[1])
            ok[ok] &= self.round_of[lane[ok], k[ok]] < 0
            self.bad += int((~ok).sum())
            valid = np.arange(out.shape[1])[None, :] < counts[:, None]
            self.outs[lane[ok], k[ok]] = out[:, :, 0][valid][ok]
            self.round_of[lane[ok], k[ok]] = r
        self.span[r] = t0, t1
        self.rounds = r + 1

    def stamp(self, lane: int) -> None:
        self.stamps[lane] = time.perf_counter()

    def close(self) -> None:
        """The last round's lanes that were not handed over are decided at
        its last hand-over (at its end where none was)."""
        if not self.rounds:
            return
        r = self.rounds - 1
        if np.isnan(self.times[r]).all():
            last = np.nanmax(self.stamps) if not np.isnan(self.stamps).all() else self.span[r, 1]
            self.times[r] = np.where(np.isnan(self.stamps), last, self.stamps)
            self.stamps[:] = np.nan

    def decided(self) -> np.ndarray:
        """Hops decided a lane."""
        return (self.round_of >= 0).sum(1)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Block ``b`` is due at ``anchor + (b + 1) * block / rate``; the window
    holds blocks [first, end)."""

    anchor: float
    block: int
    rate: float
    first: int
    end: int

    def due(self, blocks):
        return self.anchor + (np.asarray(blocks) + 1) * self.block / self.rate


def latencies(rec: Recorder, sched: Schedule, deadline: float):
    """(latencies in ms of the window's hops decided by ``deadline``, hops
    due in the window, hops failed). A hop is due in the window when the
    block carrying its last sample is; one decided after ``deadline``, or
    never (dropped), is failed."""
    hops = rec.outs.shape[1]
    blocks = (rec.first + rec.step * np.arange(hops) - 1) // sched.block
    in_window = (blocks >= sched.first) & (blocks < sched.end)
    r = rec.round_of[:, in_window]
    when = np.where(r >= 0, rec.times[np.maximum(r, 0), np.arange(len(r))[:, None]], np.inf)
    lat = (when - sched.due(blocks[in_window])[None, :]).reshape(-1)
    ok = when.reshape(-1) <= deadline
    return lat[ok] * 1e3, lat.size, int((~ok).sum())


def tail(lat_ms, failed: int, q: float) -> float:
    """The ``q``-th percentile of the window's hops, a failed hop counting
    as missing any limit (infinite)."""
    full = np.concatenate([lat_ms, np.full(failed, np.inf)])
    return float(np.percentile(full, q, method="higher"))


def window(run, state, seconds: float) -> dict:
    from syllable_detector_tpu_torch.models.detector_bank import DetectorBank
    from syllable_detector_tpu_torch.utils.timing import Time

    from benchmark.trace import DeviceTrace

    p, geom = run.params, run.geom
    rate, block, lanes = geom["sampling_rate"], p["block"], p["lanes"]
    proc = state["processor"]
    b_window = round(p["preroll_s"] * rate / block)
    b_end = b_window + int(np.ceil(seconds * rate / block))
    first, step = ref.first_output_sample(geom), roofline.hop(geom)
    due = (b_end * block - first) // step + 1  # hops a lane whose samples are all sent
    period = state["loops"].shape[1]
    reps = -(-(b_end * block) // period)
    stream = np.ascontiguousarray(np.tile(state["loops"], (1, reps))[:, : b_end * block])
    rec = Recorder(lanes, due, b_end + 1000, first, step)
    state["recorder"] = rec
    late = np.full(b_end, np.nan)
    drain = DetectorBank.drain

    def recorded(bank, *args, **kwargs):
        t0 = time.perf_counter()
        out = drain(bank, *args, **kwargs)
        t1 = time.perf_counter()
        rec.drained(bank, out, t0, t1)
        if run.trace:
            run.spans.intervals["bank.drain"].append((t0, t1))
        return out

    DetectorBank.drain = recorded
    state["stamp"] = rec.stamp
    src = proc.interface_input
    anchor = time.perf_counter() + 0.05
    sched = Schedule(anchor, block, rate, b_window, b_end)

    def feeder():
        for b in range(b_end):
            t_due = sched.due(b)
            now = time.perf_counter()
            while now < t_due:
                time.sleep(t_due - now)
                now = time.perf_counter()
            late[b] = now - t_due
            proc.receive_audio_block(src, stream[:, b * block : (b + 1) * block])
            if run.trace:
                run.spans.intervals["capture.deliver"].append((now, time.perf_counter()))

    gc_time, gc_start = [0.0, 0], [0.0]

    def gc_clock(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_time[0] += time.perf_counter() - gc_start[0]
            gc_time[1] += 1

    thread = threading.Thread(target=feeder, name="benchmark-capture")
    gc.callbacks.append(gc_clock)
    try:
        proc.set_up()
        thread.start()
        t_w0, t_w1 = sched.due(b_window - 1), sched.due(b_end - 1)
        time.sleep(max(0.0, t_w0 - time.perf_counter()))
        run.setup_s = t_w0 - run.t_start
        Time.reset()
        if run.trace:
            run.device_trace = DeviceTrace().__enter__()
        time.sleep(max(0.0, t_w1 - time.perf_counter()))
        if run.trace:
            run.work["time_stats"] = Time.summaries()
            run.device_trace.__exit__(None, None, None)
        thread.join()
        deadline = time.perf_counter() + 60.0
        while rec.decided().min() < due and time.perf_counter() < deadline:
            time.sleep(0.01)
    finally:
        proc.tear_down()
        DetectorBank.drain = drain
        gc.callbacks.remove(gc_clock)
    rec.close()
    run.window = (t_w0, t_w1)
    lat_ok, attempted, failed = latencies(rec, sched, t_w1 + p["grace_s"])
    if failed > 0.05 * attempted:
        raise RuntimeError(f"{failed} of {attempted} hops failed; no tail to report")
    p95, p50 = tail(lat_ok, failed, 95), tail(lat_ok, failed, 50)
    quarters = np.array_split(lat_ok, 4)  # the hops of a quarter of the lanes each
    print(f"live: p95 of each quarter of the lanes: {[tail(q, 0, 95) for q in quarters]}, "
          f"garbage collection {gc_time[0]:.4f} s in {gc_time[1]} passes", file=sys.stderr)
    print(f"live: {attempted} hops due in the window, {failed} failed, latency p50 {p50!r} "
          f"ms, p95 {p95!r} ms, {rec.rounds} rounds", file=sys.stderr, flush=True)
    in_window = (rec.span[: rec.rounds, 0] >= t_w0) & (rec.span[: rec.rounds, 0] < t_w1)
    run.work.update({
        "round_counts": _round_counts(rec, np.flatnonzero(in_window)),
        "feed_late_ms": late[b_window:b_end] * 1e3,
    })
    return {"metrics": {"hop_latency_p95_ms": p95}, "attempted": attempted,
            "failed": failed, "produced": rec}


def _round_counts(rec: Recorder, rounds) -> list[list[int]]:
    """Hops each lane got in each of ``rounds``."""
    lanes = rec.round_of.shape[0]
    counts = np.zeros((rec.rounds, lanes), np.int64)
    lane, k = np.nonzero(rec.round_of >= 0)
    np.add.at(counts, (rec.round_of[lane, k], lane), 1)
    return [[int(c) for c in row if c] for row in counts[rounds]]


def release(run, state) -> None:
    state.pop("processor", None)


def compare(run, state, produced) -> dict:
    """Every lane's every hop due against the reference: that it came, at
    its sample index, its output and its decision."""
    hops = run.params["loop_hops"]
    index_mismatch = int(produced.bad) + int((produced.round_of < 0).sum())
    rows_mismatch, gap = 0, 0.0
    for j, outs in enumerate(produced.outs):
        want = state["periods"][j][np.arange(len(outs)) % hops]
        came = produced.round_of[j] >= 0
        thr = np.float32(state["thresholds"][j])
        nan_got, nan_want = ~np.isfinite(outs), ~np.isfinite(want)
        finite = ~nan_got & ~nan_want & came
        rows_mismatch += int(((nan_got != nan_want) & came).sum())
        rows_mismatch += int(((outs >= thr) != (want >= np.float64(thr)))[finite].sum())
        if finite.any():
            gap = max(gap, float(np.max(np.abs(outs[finite].astype(np.float64) - want[finite]))))
    return {"index_mismatch": index_mismatch, "rows_mismatch": rows_mismatch, "out_gap": gap}


def control(run, state, seconds: float):
    """The reference put in the program's place one precision lower: every
    hop a window of ``seconds`` decides, from the TF32 reference."""
    p, geom = run.params, run.geom
    rate, block = geom["sampling_rate"], p["block"]
    b_end = round(p["preroll_s"] * rate / block) + int(np.ceil(seconds * rate / block))
    first, step = ref.first_output_sample(geom), roofline.hop(geom)
    due = (b_end * block - first) // step + 1
    rec = Recorder(p["lanes"], due, 1, first, step)
    rec.round_of[:] = 0
    for j in range(p["lanes"]):
        period = reference_period(geom, state["nets"][j], state["x"][j], p["loop_hops"], "tf32")
        rec.outs[j] = period[np.arange(due) % p["loop_hops"]]
    return rec
