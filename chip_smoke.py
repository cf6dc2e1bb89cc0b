"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

  1. device  — require a CUDA card; print its name and power limit.
  2. build   — build the fused detector kernel from csrc/ with nvcc.
  3. kernel  — the kernel against its plain PyTorch version and the
               unfused path, on the card, for every configuration of
               fixtures.fused_cases (10 s streams, a short one, log and dB
               scaling, a gap geometry, a 3-layer net).
  4. main    — the port's CLI (``cli.main``) on a 2-channel chirp WAV with
               a fixture net, with --method fused and --method matmul: the
               CSVs must agree, the fused run must launch the kernel, and
               the tensors must live on the card.
  5. times   — device (CUDA-event) and host medians of the kernel and its
               plain version on a 60 s stream and on one CLI drain step,
               and host-clock times of a CLI run of the 60 s file per
               method.
  6. batch   — the batched kernel (one launch per drain round, wire
               dequantised inside) against its plain version for the
               float32, int16 and mu-law wires with shared and per-lane
               nets: 256 lanes x bucket 128, 256 lanes x bucket 8, and 3
               ragged lanes whose zero tails give NaN.
  7. live    — the live batched path at full width: a 256-lane
               DetectorBank (one seeded net per lane, int16 wire,
               2048-sample chunks over 10 s, one gap) fused against
               matmul; the port's monitor with 256 channels batched
               (int16 wire, pinned ladder 128) fused against matmul; 8
               channels per lane (fused) against batched (float32 wire);
               8 channels on the mu-law wire fused against matmul. Event
               logs must be equal and no drain may fail.
  8. times   — device time of one 256 x 128 round per wire, kernel
               against plain; host time per bank.drain() round split into
               staging, copy and launch; audio seconds per wall second of
               the 256-lane monitor run.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from syllable_detector_tpu.config.model_format import save_config
from syllable_detector_tpu.utils.wav import write_wav
from syllable_detector_tpu_torch import cli, fixtures, monitor
from syllable_detector_tpu_torch.kernels import _build
from syllable_detector_tpu_torch.kernels import fused_detector as fused
from syllable_detector_tpu_torch.models import detector
from syllable_detector_tpu_torch.models.detector_bank import (
    DetectorBank,
    _mulaw_lut,
    mulaw_expand_np,
)
from syllable_detector_tpu_torch.ops.stft import num_frames

KERNEL_SOURCE = "syllable_detector_tpu_torch/csrc/fused_detector.cu"
REPLACES = "syllable_detector_tpu/kernels/fused_detector.py:671"
REPLACES_FLAT = "syllable_detector_tpu/kernels/fused_detector.py:1704"
REPLACES_PROGRAM = "syllable_detector_tpu/kernels/fused_detector.py:1615"
LANES = 256  # the live-scale harness's lane count (scripts/live_scale_hw.py)
CHUNK = 2048  # its capture chunk
WIRES = ("float32", "int16", "mulaw8")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, samples: int = 21, batch: int = 10) -> tuple[float, float]:
    """(device ms, host ms) per call: the median over ``samples`` of the
    mean of ``batch`` calls, after warm-up. Device time comes from CUDA
    events. The stream is first held busy (``torch.cuda._sleep``) until the
    host has enqueued the whole batch, so the events time the device's work
    and not the host's launch rate; the host time is the enqueue time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    device, host = [], []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~30 ms at the H100's clock
        start.record()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / batch)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / batch)
    return statistics.median(device), statistics.median(host)


def run_cli(argv: list[str]) -> tuple[list[str], float]:
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}")
    return out.getvalue().splitlines(), seconds


def compare_csv(got: list[str], want: list[str]) -> float:
    """Columns 1-3 identical, outputs within rtol=1e-4, atol=1e-5; returns
    the largest output difference."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} CSV lines against {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        gp, wp = g.split(","), w.split(",")
        if gp[:3] != wp[:3]:
            raise AssertionError(f"CSV lines differ: {g!r} vs {w!r}")
        a = np.array(gp[3:], np.float64)
        b = np.array(wp[3:], np.float64)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def phase_kernel() -> float:
    worst = 0.0
    for name, cfg, x, rtol, atol in fixtures.fused_cases(10.0):
        spec, params = detector.detector_spec_from_config(cfg, "cuda")
        xd = torch.from_numpy(x).cuda()
        folded = fused.fold_constants(spec, params, "cuda")
        launches = fused.LAUNCHES
        got = fused.fused_offline_outputs(spec, params, xd, folded=folded)
        torch.cuda.synchronize()
        if fused.LAUNCHES != launches + 1 or not got.is_cuda:
            raise AssertionError(f"{name}: the kernel was not launched")
        plain = fused.fused_offline_outputs_reference(spec, folded, xd)
        unfused = detector.offline_outputs(spec, params, xd)
        g, p, u = (t.cpu().numpy() for t in (got, plain, unfused))
        if g.shape != p.shape or g.shape != u.shape or not len(g):
            raise AssertionError(f"{name}: shapes {g.shape} {p.shape} {u.shape}")
        for want in (p, u):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(want), err_msg=name)
            np.testing.assert_allclose(g, want, rtol=rtol, atol=atol, err_msg=name)
        finite = np.isfinite(p)
        abs_err = np.abs(g - p)[finite]
        rel_err = abs_err / np.maximum(np.abs(p[finite]), 1e-30)
        worst = max(worst, float(abs_err.max()))
        print(
            f"phase 3 kernel {name}: evals {len(g)}, NaN {int((~finite).sum())}, "
            f"vs plain max_abs {abs_err.max():.3g} max_rel {rel_err.max():.3g}, "
            f"vs unfused max_abs {np.abs(g - u)[finite].max():.3g} "
            f"(rtol={rtol}, atol={atol}) ok",
            flush=True,
        )
    return worst


def phase_main(tmp: str) -> int:
    audio = np.stack([fixtures.chirp_audio(4.0, 11), fixtures.chirp_audio(4.0, 12)], 1)
    cfg = fixtures.pick_thresholds(fixtures.sample_geometry_config(0), audio)
    net, wav = os.path.join(tmp, "net.txt"), os.path.join(tmp, "two.wav")
    save_config(cfg, net)
    write_wav(wav, audio, int(cfg.sampling_rate), dtype="float32")
    argv = ["-n", net, "-a", wav, "--device", "cuda"]

    fused.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    fused_csv, _ = run_cli(argv + ["--method", "fused"])
    launches = fused.LAUNCHES
    fused_bytes = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    matmul_csv, _ = run_cli(argv + ["--method", "matmul"])
    matmul_bytes = torch.cuda.max_memory_allocated()

    if launches <= 0:
        raise AssertionError("the fused CLI run launched no kernel")
    if fused_bytes <= 0 or matmul_bytes <= 0:
        raise AssertionError("the CLI runs allocated nothing on the card")
    n_evals = num_frames(len(audio), cfg.window_length, cfg.window_overlap) - cfg.time_range + 1
    per_channel = [sum(line.startswith(f"{c},") for line in fused_csv) for c in (0, 1)]
    if not 0 < sum(per_channel) < 2 * n_evals:
        raise AssertionError(f"detections {per_channel} of {n_evals} evals per channel")
    worst = compare_csv(fused_csv, matmul_csv)
    print(
        f"phase 4 main path: cli --method fused vs matmul on 2 x {len(audio)} samples: "
        f"{len(fused_csv)} detection lines (per channel {per_channel} of {n_evals} evals), "
        f"columns 1-3 identical, outputs max diff {worst:.3g}; fused kernel launches "
        f"{launches}; peak card memory fused {fused_bytes} B, matmul {matmul_bytes} B ok",
        flush=True,
    )
    return launches


def phase_times(tmp: str, card_line: str) -> tuple[float, float]:
    cfg = fixtures.sample_geometry_config(0)
    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    folded = fused.fold_constants(spec, params, "cuda")
    x = fixtures.chirp_audio(60.0, 21)
    # the 60 s stream, and the samples one CLI drain step hands the kernel
    # (a 65536-sample chunk plus the retained T-1 hops)
    chunk = (cli.CHUNK // spec.hop + spec.time_range - 1) * spec.hop + spec.window_length
    results = {}
    for name, n in (("60 s stream", len(x)), ("CLI chunk", chunk)):
        xd = torch.from_numpy(x[:n]).cuda()
        n_evals = num_frames(n, cfg.window_length, cfg.window_overlap) - cfg.time_range + 1
        kernel = event_ms(lambda: fused.fused_offline_outputs(spec, params, xd, folded=folded))
        plain = event_ms(lambda: fused.fused_offline_outputs_reference(spec, folded, xd))
        results[name] = (kernel[0], plain[0])
        print(
            f"phase 5 times [{card_line}]: {name} ({n} samples, {n_evals} evals), "
            f"median of 21 x 10 calls: kernel {kernel[0]:.4f} ms device "
            f"({kernel[1]:.4f} ms host enqueue), plain fused {plain[0]:.4f} ms device "
            f"({plain[1]:.4f} ms host enqueue)",
            flush=True,
        )
    net, wav = os.path.join(tmp, "net60.txt"), os.path.join(tmp, "sixty.wav")
    save_config(fixtures.pick_thresholds(cfg, x), net)
    write_wav(wav, x, int(cfg.sampling_rate), dtype="float32")
    for method in ("fused", "matmul"):
        argv = ["-n", net, "-a", wav, "--device", "cuda", "--method", method]
        run_cli(argv)  # warm-up
        runs = [run_cli(argv)[1] for _ in range(5)]
        print(
            f"phase 5 times [{card_line}]: cli --method {method} on the 60 s file, "
            f"host clock median of 5 runs {statistics.median(runs):.4f} s "
            f"(runs {', '.join(f'{r:.4f}' for r in runs)})",
            flush=True,
        )
    return results["60 s stream"]


def bucket_samples(spec, bucket: int) -> int:
    """Samples per lane of one drain round of ``bucket`` evaluations."""
    return (bucket + spec.time_range - 2) * spec.hop + spec.window_length


def to_wire(x: np.ndarray, wire: str) -> np.ndarray:
    """Float samples on the bank's wire: clip and round to int16, then the
    mu-law table for the 8-bit wire (DetectorBank's staging)."""
    if wire == "float32":
        return x
    q = np.rint(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    return q if wire == "int16" else _mulaw_lut()[q.astype(np.int32) + 32768]


def reset_counts() -> None:
    fused.LAUNCHES = 0
    fused.BATCH_LAUNCHES = 0
    fused.PROGRAM_LAUNCHES = {wire: 0 for wire in fused.PROGRAM_LAUNCHES}


def program_launches(wire: str) -> int:
    return fused.BATCH_LAUNCHES if wire == "float32" else fused.PROGRAM_LAUNCHES[wire]


def phase_batch(pairs) -> dict:
    """The batched kernel against its plain version; returns the largest
    absolute difference per wire."""
    spec = pairs[0][0]
    params = [p for _, p in pairs]
    rng = np.random.default_rng(6)
    ragged = bucket_samples(spec, 37) + 55
    cases = [
        (f"{LANES} x 128", LANES, bucket_samples(spec, 128), None),
        (f"{LANES} x 8", LANES, bucket_samples(spec, 8), None),
        ("3 ragged", 3, ragged, (ragged, 3000, 1500)),
    ]
    worst = {wire: 0.0 for wire in WIRES}
    for name, lanes, n, valid in cases:
        x = rng.uniform(-0.7, 0.7, (lanes, n)).astype(np.float32)
        if valid is not None:
            for lane, m in enumerate(valid):
                x[lane, m:] = 0.0  # the bank's zero tails: NaN under l2normalize
        n_evals = num_frames(n, spec.window_length, spec.window_overlap) - spec.time_range + 1
        folds = {
            "per-lane": fused.fold_constants_stacked(spec, params[:lanes], "cuda"),
            "shared": fused.fold_constants(spec, params[0], "cuda"),
        }
        for wire in WIRES:
            xd = torch.from_numpy(to_wire(x, wire)).cuda()
            for nets, folded in folds.items():
                prog = fused.BatchProgram(spec, folded, lanes, n, n_evals, wire, "cuda")
                before = program_launches(wire)
                got = prog.launch(xd)
                torch.cuda.synchronize()
                if program_launches(wire) != before + 1 or not got.is_cuda:
                    raise AssertionError(f"{name} {wire} {nets}: the kernel was not launched")
                plain = fused.fused_batch_outputs_reference(spec, folded, xd, wire, n_evals)
                g, p = got.cpu().numpy(), plain.cpu().numpy()
                if g.shape != (lanes, n_evals, spec.net.outputs) or g.shape != p.shape:
                    raise AssertionError(f"{name}: shapes {g.shape} {p.shape}")
                np.testing.assert_array_equal(np.isnan(g), np.isnan(p), err_msg=name)
                np.testing.assert_allclose(g, p, rtol=1e-3, atol=2e-4, err_msg=f"{name} {wire}")
                nan = np.isnan(g)
                if valid is not None and not (nan[1:].any() and not nan[0].any()):
                    raise AssertionError(f"{name}: NaN not in the zero tails only")
                finite = ~nan
                err = float(np.abs(g - p)[finite].max())
                worst[wire] = max(worst[wire], err)
                print(
                    f"phase 6 batch {name} ({n} samples, {n_evals} evals) {wire} {nets} nets: "
                    f"NaN {int(nan.sum())}, vs plain max_abs {err:.3g} "
                    f"(rtol=1e-3, atol=2e-4) ok",
                    flush=True,
                )
    return worst


def drain_all(bank, audio, gap_at, gap_len, chunks):
    """Feed every lane ``chunks`` capture chunks of ``audio`` (lanes with
    lane % 4 == 0 lose ``gap_len`` samples before chunk ``gap_at``),
    draining after each; returns per-lane (outputs, sample indices) and
    the host seconds of each drain call."""
    lanes = bank.n_lanes
    pos = [0] * lanes
    outs = [[] for _ in range(lanes)]
    idx = [[] for _ in range(lanes)]
    seconds = []

    def collect(flush=False):
        t0 = time.perf_counter()
        out = bank.drain(flush=flush)
        seconds.append(time.perf_counter() - t0)
        for lane in range(lanes):
            c = int(bank.last_counts[lane])
            if c:
                outs[lane].append(out[lane, :c])
                idx[lane].append(bank.last_sample_indices[lane])
            if np.isnan(out[lane, c:]).any():
                raise AssertionError("a padding row reached the result")

    for k in range(chunks):
        for lane in range(lanes):
            if k == gap_at and lane % 4 == 0:
                bank.note_gap(lane, gap_len)
                pos[lane] += gap_len
            bank.append_audio_data(lane, audio[pos[lane] : pos[lane] + CHUNK])
            pos[lane] += CHUNK
        collect()
    collect(flush=True)
    return [np.concatenate(o) for o in outs], [np.concatenate(i) for i in idx], seconds


def compare_lanes(got, want, what: str) -> float:
    worst = 0.0
    for lane, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(got[1][lane], want[1][lane], err_msg=f"{what} lane {lane}")
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} lane {lane}")
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-4, err_msg=f"{what} lane {lane}")
        finite = np.isfinite(g)
        worst = max(worst, float(np.abs(g - w)[finite].max()))
    return worst


def run_monitor(argv: list[str]) -> tuple[list[str], float]:
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = monitor.main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:  # also when any drain failed
        raise RuntimeError(f"monitor.main returned {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue().splitlines(), seconds


def read_events(path: str) -> list[list[str]]:
    with open(path) as fh:
        rows = [line.split(",") for line in fh.read().splitlines()]
    return sorted(rows, key=lambda r: (int(r[0]), int(r[1])))


def compare_events(got: str, want: str, what: str) -> tuple[int, float]:
    g, w = read_events(got), read_events(want)
    if [r[:3] for r in g] != [r[:3] for r in w]:
        raise AssertionError(f"{what}: event logs differ ({len(g)} against {len(w)} rows)")
    if not g:
        raise AssertionError(f"{what}: no event")
    a = np.array([r[3:] for r in g], np.float64)
    b = np.array([r[3:] for r in w], np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4, err_msg=what)
    return len(g), float(np.abs(a - b).max())


def phase_live(tmp: str, cfgs, audio, card_line: str) -> dict:
    """The live path at full width; returns the main-path launch counts and
    the 256-lane monitor's audio seconds per wall second."""
    spec = detector.detector_spec_from_config(cfgs[0], "cpu")[0]
    chunks = len(audio) // CHUNK
    gap_at = chunks // 2
    # a gap whose far side lands on the hop grid of the whole stream, so
    # that the thresholds' margins hold on both sides of it
    gap_len = (-(gap_at * CHUNK)) % spec.hop + 10 * spec.hop
    results = {}
    for name, kw in (
        ("fused, ladder (128,)", dict(method="fused", buckets=(128,))),
        ("fused, default ladder", dict(method="fused")),
        ("matmul", dict(method="matmul")),
    ):
        bank = DetectorBank(cfgs, transfer_dtype="int16", device="cuda", **kw)
        reset_counts()
        t0 = time.perf_counter()
        results[name] = drain_all(bank, audio, gap_at, gap_len, chunks)
        wall = time.perf_counter() - t0
        launches = fused.PROGRAM_LAUNCHES["int16"]
        if (kw["method"] == "fused") != (launches > 0):
            raise AssertionError(f"bank {name}: {launches} int16 launches")
        rows = sum(len(o) for o in results[name][0])
        print(
            f"phase 7 live bank {name} [{card_line}]: {LANES} lanes x {chunks} chunks of "
            f"{CHUNK} int16 samples, gap of {gap_len} on every 4th lane: {rows} outputs in "
            f"{len(results[name][2])} drains, {wall:.2f} s; int16 launches {launches} ok",
            flush=True,
        )
    for name in ("fused, ladder (128,)", "fused, default ladder"):
        worst = compare_lanes(results[name], results["matmul"], name)
        print(f"phase 7 live bank {name} vs matmul: indices equal, max_abs {worst:.3g} ok", flush=True)

    wav = os.path.join(tmp, "live.wav")
    write_wav(wav, audio, int(spec.sampling_rate), dtype="float32")
    nets = []
    for i, cfg in enumerate(cfgs):
        nets.append(os.path.join(tmp, f"live{i}.txt"))
        save_config(cfg, nets[-1])
    seconds = 8.0  # under the 10 s rings, so no ring overflow
    common = ["-a", wav, "--duration", str(seconds), "--frame-size", str(CHUNK),
              "--refresh", "600", "--device", "cuda"]
    launches = {}

    def monitor_pair(tag, argv_a, argv_b, count):
        logs = []
        for i, argv in enumerate((argv_a, argv_b)):
            log = os.path.join(tmp, f"{tag}{i}.csv")
            reset_counts()
            out, wall = run_monitor(argv + ["--event-log", log])
            if i == 0:
                launches[tag] = count()
                if launches[tag] <= 0:
                    raise AssertionError(f"monitor {tag}: the kernel was not launched")
                first = (out, wall)
            logs.append(log)
        rows, worst = compare_events(logs[0], logs[1], tag)
        return first, rows, worst

    all_nets = [a for n in nets for a in ("-n", n)]
    batched = ["--channels", str(LANES), "--batched-drain", "--wire-format", "int16",
               "--buckets", "128"]
    (out, wall), rows, worst = monitor_pair(
        "int16", all_nets + common + batched,
        all_nets + common + batched + ["--method", "matmul"],
        lambda: fused.PROGRAM_LAUNCHES["int16"],
    )
    rate = LANES * seconds / wall
    print(
        f"phase 7 live monitor [{card_line}]: --channels {LANES} --batched-drain "
        f"--wire-format int16 --buckets 128, fused vs matmul: {rows} events equal in columns "
        f"1-3, outputs max diff {worst:.3g}, int16 launches {launches['int16']}, drain errors 0; "
        f"{seconds} s of audio per channel in {wall:.2f} s ok",
        flush=True,
    )
    eight = [a for n in nets[:8] for a in ("-n", n)] + common[:2] + [
        "--duration", "3", "--frame-size", str(CHUNK), "--refresh", "600",
        "--device", "cuda", "--channels", "8"]
    (_, _), rows, worst = monitor_pair(
        "float32", eight + ["--batched-drain"], eight + ["--method", "fused"],
        lambda: fused.BATCH_LAUNCHES,
    )
    launches["per-lane"] = fused.LAUNCHES
    if launches["per-lane"] <= 0:
        raise AssertionError("the per-lane fused monitor launched no kernel")
    print(
        f"phase 7 live monitor: 8 channels --batched-drain (float32 wire) vs per lane "
        f"--method fused: {rows} events equal in columns 1-3, outputs max diff {worst:.3g}; "
        f"batch launches {launches['float32']}, per-lane launches {launches['per-lane']}, "
        f"drain errors 0 ok",
        flush=True,
    )

    # the mu-law wire quantises coarsely: thresholds are picked on the audio
    # the nets see through it
    heard = mulaw_expand_np(to_wire(audio, "mulaw8"))
    mu_nets = []
    for i, cfg in enumerate(cfgs[:8]):
        mu_nets += ["-n", os.path.join(tmp, f"mu{i}.txt")]
        save_config(fixtures.pick_thresholds(cfg, heard[: 3 * 44100], device="cuda"), mu_nets[-1])
    mu = mu_nets + eight[16:] + ["--batched-drain", "--wire-format", "mulaw8"]
    (_, _), rows, worst = monitor_pair(
        "mulaw8", mu, mu + ["--method", "matmul"], lambda: fused.PROGRAM_LAUNCHES["mulaw8"]
    )
    print(
        f"phase 7 live monitor: 8 channels --wire-format mulaw8 fused vs matmul: {rows} events "
        f"equal in columns 1-3, outputs max diff {worst:.3g}; mulaw8 launches "
        f"{launches['mulaw8']}, drain errors 0 ok",
        flush=True,
    )
    return {"launches": launches, "audio_per_wall": rate}


def phase_live_times(cfgs, audio, card_line: str) -> dict:
    """Device times of one 256 x 128 round per wire, and the host's time
    per bank.drain() round, split."""
    pairs = [detector.detector_spec_from_config(c, "cuda") for c in cfgs]
    spec = pairs[0][0]
    n = bucket_samples(spec, 128)
    n_evals = 128
    folded = fused.fold_constants_stacked(spec, [p for _, p in pairs], "cuda")
    x = np.stack([np.roll(audio, 97 * lane)[:n] for lane in range(LANES)])
    times = {}
    for wire in WIRES:
        xd = torch.from_numpy(to_wire(x, wire)).cuda()
        prog = fused.BatchProgram(spec, folded, LANES, n, n_evals, wire, "cuda")
        kernel = event_ms(lambda: prog.launch(xd))
        plain = event_ms(lambda: fused.fused_batch_outputs_reference(spec, folded, xd, wire, n_evals))
        times[wire] = (kernel[0], plain[0])
        print(
            f"phase 8 times [{card_line}]: one {LANES} x 128 round ({n} {wire} samples per lane, "
            f"{LANES * n_evals} evals), median of 21 x 10 calls: kernel {kernel[0]:.4f} ms device "
            f"({kernel[1]:.4f} ms host enqueue), plain {plain[0]:.4f} ms device "
            f"({plain[1]:.4f} ms host enqueue)",
            flush=True,
        )

    bank = DetectorBank(cfgs, transfer_dtype="int16", buckets=(128,), device="cuda")
    bank.warm_up()
    prog = bank._program(n)
    stager = bank._stager
    if stager is None:
        raise AssertionError("the native drain stager did not build")
    hop_block = 128 * spec.hop
    for lane in range(LANES):  # the retained context, then 128 hops per round
        bank.append_audio_data(lane, audio[: n - hop_block])
    split = {label: {k: [] for k in ("stage", "copy", "launch", "readback", "drain")}
             for label in ("native", "numpy")}
    r = 0
    # the two stagings in turns, 4 x 11 rounds
    for label in ("native", "numpy", "numpy", "native"):
        bank._stager = stager if label == "native" else None
        for _ in range(11):
            start = (r * hop_block) % (len(audio) - hop_block)
            r += 1
            for lane in range(LANES):
                bank.append_audio_data(lane, audio[start : start + hop_block])
            avail = [bank._front_avail(lane) for lane in range(LANES)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs = bank._stage_round(avail, n)
            t1 = time.perf_counter()
            xd = prog.upload(xs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = prog.launch(xd)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            out.cpu().numpy()
            t4 = time.perf_counter()
            bank.drain()
            t5 = time.perf_counter()
            if int(bank.last_counts.min()) != 128:
                raise AssertionError(f"round {r}: counts {bank.last_counts.min()}")
            for k, v in zip(("stage", "copy", "launch", "readback", "drain"),
                            (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                split[label][k].append(v * 1e3)
    bank._stager = stager
    for label, parts in split.items():
        med = {k: statistics.median(v) for k, v in parts.items()}
        print(
            f"phase 8 times [{card_line}]: host per bank.drain() round ({LANES} lanes, int16 "
            f"wire, bucket 128, {LANES * n * 2} wire bytes), {label} staging, median of 22: "
            f"whole drain {med['drain']:.3f} ms; staging {med['stage']:.3f} ms, host->device "
            f"copy {med['copy']:.3f} ms, launch to completion {med['launch']:.3f} ms, "
            f"device->host copy {med['readback']:.3f} ms",
            flush=True,
        )
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    print(card_line, flush=True)
    print(
        f"phase 1 device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"card(s), torch {torch.__version__}, CUDA {torch.version.cuda} ok",
        flush=True,
    )

    _, seconds, log = _build.build("fused_detector")
    regs = [line.strip() for line in log.splitlines() if "registers" in line]
    print(f"phase 2 build: fused_detector.cu in {seconds:.2f} s; {' '.join(regs)} ok", flush=True)

    max_abs_err = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main(tmp)
        kernel_ms, plain_ms = phase_times(tmp, card_line)

        # the live path's nets: one seeded net per lane, each threshold away
        # from every output on the audio, which lies on the int16 grid so
        # that the int16 wire carries it exactly
        audio = fixtures.chirp_audio(10.0, 41)
        audio = (np.rint(audio * 32767.0) / 32767.0).astype(np.float32)
        cfgs = [
            fixtures.pick_thresholds(fixtures.sample_geometry_config(1000 + lane), audio,
                                     device="cuda")
            for lane in range(LANES)
        ]
        pairs = [detector.detector_spec_from_config(c, "cuda") for c in cfgs]
        batch_err = phase_batch(pairs)
        live = phase_live(tmp, cfgs, audio, card_line)
        times = phase_live_times(cfgs, audio, card_line)
    print(
        f"phase 8 times [{card_line}]: the {LANES}-channel monitor run processed "
        f"{live['audio_per_wall']:.1f} audio seconds per wall second",
        flush=True,
    )

    def entry(name, replaces, launches, err, ms):
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1]}

    n = live["launches"]
    print(json.dumps({"kernels": [
        entry("fused_detector", REPLACES, launches, max_abs_err, (kernel_ms, plain_ms)),
        entry("fused_detector_batch", REPLACES_FLAT, n["float32"], batch_err["float32"],
              times["float32"]),
        entry("fused_batch_program int16", REPLACES_PROGRAM, n["int16"], batch_err["int16"],
              times["int16"]),
        entry("fused_batch_program mulaw8", REPLACES_PROGRAM, n["mulaw8"], batch_err["mulaw8"],
              times["mulaw8"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
