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
from syllable_detector_tpu_torch import cli, fixtures
from syllable_detector_tpu_torch.kernels import _build
from syllable_detector_tpu_torch.kernels import fused_detector as fused
from syllable_detector_tpu_torch.models import detector
from syllable_detector_tpu_torch.ops.stft import num_frames

KERNEL_SOURCE = "syllable_detector_tpu_torch/csrc/fused_detector.cu"
REPLACES = "syllable_detector_tpu/kernels/fused_detector.py:671"


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

    print(json.dumps({"kernels": [{
        "name": "fused_detector",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
