"""Corpus traffic: the batched scan of a set of files, scan after scan.

Set-up writes ``files`` seeded ``channels``-channel S16 WAVs of
``file_seconds`` each into the run's TMPDIR, their rates cycling through
``rates``, every channel its own song (``synth.chirp``). One seeded net
scans them; its threshold lies ``margin`` away from every output the plain
reference gives on what the net hears (each file resampled to the net's
rate where the rates differ). The window runs
``corpus.scan_corpus_files(method="fused")`` as ``cli --batched --method
fused`` calls it, its CSV lines collected in memory, back to back; the scan
in flight at the deadline is finished and counted, and the window ends
with it.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from benchmark import harness, program, roofline, synth
from benchmark.reference import detect as ref


def _files(run) -> list[tuple[str, float]]:
    """(path, rate) of every file of the corpus."""
    p = run.params
    folder = os.path.join(tempfile.gettempdir(), "sd_benchmark", run.cell)
    rates = p["rates"]
    return [(os.path.join(folder, f"corpus{i}_{rates[i % len(rates)]}.wav"),
             float(rates[i % len(rates)])) for i in range(p["files"])]


def setup(run):
    p, geom, device = run.params, run.geom, run.device
    net_rate = geom["sampling_rate"]
    gen = synth.generator(run.seed, device)
    net = synth.net(geom, gen, device)
    files = _files(run)
    os.makedirs(os.path.dirname(files[0][0]), exist_ok=True)
    heard = []  # per lane: the reference's outputs on what the net hears
    codes_all = []
    for path, rate in files:
        n = int(p["file_seconds"] * rate)
        codes = torch.stack([synth.to_s16(synth.chirp(n, rate, gen, device), 32768.0)
                             for _ in range(p["channels"])], 1)
        codes_all.append(codes.cpu().numpy())
        synth.write_wav_s16(path, codes_all[-1], int(rate))
        for c in range(p["channels"]):
            x = codes[:, c].to(torch.float64) / 32768.0
            heard.append(ref.outputs(geom, net, ref.resample(x, rate, net_rate)).cpu().numpy())
    harness.note(run, "corpus written, reference outputs computed")
    threshold = synth.pick_thresholds(np.concatenate(heard), p["margin"])
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cfg = program.port_config(geom, net, threshold)
    state = {"net": net, "cfg": cfg, "files": files, "heard": heard, "codes": codes_all,
             "threshold": threshold}
    state["warm_lines"] = _scan(run, state)  # set-up: every shape built once
    return state


def _scan(run, state) -> list[str]:
    from syllable_detector_tpu_torch import corpus

    lines, errors = [], []
    corpus.scan_corpus_files([state["cfg"]], [f for f, _ in state["files"]],
                             debounce_seconds=None, emit=lines.append, err=errors.append,
                             method="fused", resample=True, device=run.device)
    if any(e.startswith("Unable") for e in errors):
        raise RuntimeError(f"the scan failed: {errors}")
    return lines


def _work(run, state) -> dict:
    """What one scan computes, from shapes: each lane's samples at the net's
    rate, and each resampled channel's framed GEMM."""
    net_rate = run.geom["sampling_rate"]
    lanes, k2 = [], []
    for path, rate in state["files"]:
        n = int(run.params["file_seconds"] * rate)
        up, down, h = ref.plan(rate, net_rate)
        n_out = n if h is None else -(-n * up // down)
        lanes += [n_out] * run.params["channels"]
        if h is not None:
            k2 += [ref.framed_shape(n, up, down, h)] * run.params["channels"]
    return {"lane_samples": lanes, "k2": k2}


def window(run, state, seconds: float) -> dict:
    from syllable_detector_tpu_torch import corpus

    from benchmark.trace import DeviceTrace

    spans = []
    if run.trace:
        spans = [run.spans.around(corpus, "corpus_csv_lines", "corpus.corpus_csv_lines"),
                 run.spans.around(corpus, "resample_channels", "corpus.resample_channels"),
                 run.spans.around(corpus, "read_audio", "corpus.read_audio"),
                 run.spans.around(corpus, "scan_corpus", "corpus.scan_corpus")]
        for s in spans:
            s.__enter__()
    scans = []
    try:
        t0 = time.perf_counter()
        run.setup_s = t0 - run.t_start
        if run.trace:
            run.device_trace = DeviceTrace().__enter__()
        while True:
            a = time.perf_counter()
            scans.append(_scan(run, state))
            t1 = time.perf_counter()
            harness.note(run, f"scan {len(scans)}: {t1 - a:.4f} s")
            if run.trace:
                run.spans.intervals["corpus.scan_corpus_files"].append((a, t1))
            if t1 - t0 >= seconds:
                break
        if run.trace:
            run.device_trace.__exit__(None, None, None)
    finally:
        for s in reversed(spans):
            s.__exit__(None, None, None)
    run.window = (t0, t1)
    work = _work(run, state)
    run.work.update(work, scans=len(scans))
    channel_s = len(scans) * len(work["lane_samples"]) * run.params["file_seconds"]
    return {"metrics": {"corpus_audio_s_per_s": channel_s / (t1 - t0)},
            "attempted": len(scans), "failed": 0, "produced": scans}


def release(run, state) -> None:
    state.pop("cfg", None)


def _expected(run, state, outputs) -> dict:
    """{(file, channel, sample): output} of every line due, from per-lane
    outputs (the reference's, or the control's)."""
    geom = run.geom
    first, step = ref.first_output_sample(geom), roofline.hop(geom)
    thr = float(state["threshold"])
    due, lane = {}, 0
    for i, _ in enumerate(state["files"]):
        for c in range(run.params["channels"]):
            out = outputs[lane]
            for k in np.flatnonzero(out >= thr):
                due[(i, c, int(first + step * k))] = float(out[k])
            lane += 1
    return due


def _parse(run, state, lines: list[str]) -> tuple[dict, int]:
    """({(file, channel, sample): output} of a scan's lines, lines that are
    malformed, out of file order or give the wrong seconds)."""
    rate = run.geom["sampling_rate"]
    paths = [f for f, _ in state["files"]]
    got, bad, file_i = {}, 0, -1
    for line in lines:
        if line in paths:
            bad += paths.index(line) != file_i + 1
            file_i = paths.index(line)
            continue
        parts = line.split(",")
        try:
            c, s, sec, out = int(parts[0]), int(parts[1]), float(parts[2]), float(parts[3])
        except (IndexError, ValueError):
            bad += 1
            continue
        bad += len(parts) != 4 or abs(sec - s / rate) > 1e-9 or (file_i, c, s) in got
        got[(file_i, c, s)] = out
    return got, bad + (file_i != len(paths) - 1)


def compare(run, state, produced) -> dict:
    """Every scan's CSV lines against the reference's: the lines due (a
    file's header, then each channel's detections: its sample, its seconds,
    its output) and each line's output."""
    want = _expected(run, state, state["heard"])
    mismatch, gap = 0, 0.0
    for lines in produced:
        got, bad = _parse(run, state, lines)
        mismatch += bad + len(set(got) ^ set(want))
        common = [k for k in got if k in want]
        if common:
            gap = max(gap, max(abs(got[k] - want[k]) for k in common))
    return {"lines_mismatch": mismatch, "out_gap": gap}


def control(run, state, seconds: float):
    """The lines of one scan by the reference one precision lower (TF32)."""
    geom, net = run.geom, state["net"]
    first, step = ref.first_output_sample(geom), roofline.hop(geom)
    outs, lane = [], 0
    for (path, rate), codes in zip(state["files"], state["codes"]):
        for c in range(run.params["channels"]):
            x = torch.as_tensor(codes[:, c], device=run.device).to(torch.float32) / 32768.0
            y = ref.outputs(geom, net, ref.resample(x, rate, geom["sampling_rate"], "tf32"),
                            "tf32")
            outs.append(y.cpu().numpy().astype(np.float32))
    lines = []
    for i, (path, _) in enumerate(state["files"]):
        lines.append(path)
        for c in range(run.params["channels"]):
            out = outs[lane + c]
            for k in np.flatnonzero(out >= state["threshold"]):
                s = int(first + step * k)
                lines.append(f"{c},{s},{s / geom['sampling_rate']!r},{out[k]}")
        lane += run.params["channels"]
    return [lines]
