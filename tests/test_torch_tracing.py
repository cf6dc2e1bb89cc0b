"""The port's spans: the bounded ring of ``utils/timing`` and the spans the
corpus scan, the train CLI with its trainer, and the live round record at
their call boundaries, on the CPU.

Spans are read back from the ring between two ``perf_counter_ns`` readings
around the call. A corpus scan records at most 40 spans and a quiet
``train.main`` run at most 30, whatever its epoch count; the live round's
spans times the live cell's rounds over a 30 s window fit the ring.
``trainer.capture`` and ``trainer.replays`` exist only on a card.
"""

import contextlib
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from syllable_detector_tpu_torch import corpus, fixtures
from syllable_detector_tpu_torch import train as ptrain
from syllable_detector_tpu_torch.ops.stft import num_frames
from syllable_detector_tpu_torch.runtime import audio_io, processor
from syllable_detector_tpu_torch.utils import make_labeled_audio, timing
from syllable_detector_tpu_torch.utils.wav import _read_pcm16_into, read_audio, write_wav

torch.set_num_threads(1)

# the live cell's rounds: one a 128-sample block at 44.1 kHz, over 30 s
LIVE_ROUNDS = 30 * 44100 // 128


@pytest.fixture(autouse=True)
def fresh_ring():
    timing.Time.reset()
    was = timing.set_recording(True)
    yield
    timing.set_recording(was)
    timing.Time.reset()


def recorded(fn):
    """(what ``fn()`` returned, the spans it recorded, in the order they
    ended)."""
    lo = time.perf_counter_ns()
    out = fn()
    hi = time.perf_counter_ns()
    return out, [s for s in timing.spans(lo, hi) if s.start_ns >= lo]


def named(spans, name):
    return [s for s in spans if s.name == name]


def in_order(*spans):
    return all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


# -- the ring -----------------------------------------------------------------


def test_nesting_gives_parents_counts_and_perf_counter_times():
    before = time.perf_counter_ns()
    with timing.span("outer", a=1) as outer:
        with timing.span("inner") as inner:
            inner.counts["b"] = 2
        timing.record("known", before, before + 5, c=3)
    after = time.perf_counter_ns()
    got = timing.spans()
    assert [s.name for s in got] == ["inner", "known", "outer"]
    s = {x.name: x for x in got}
    assert s["outer"].id == outer.id and s["outer"].parent == -1
    assert s["inner"].parent == s["known"].parent == outer.id
    assert [s[n].counts for n in ("outer", "inner", "known")] == [{"a": 1}, {"b": 2}, {"c": 3}]
    assert before <= s["outer"].start_ns <= s["inner"].start_ns <= s["inner"].end_ns
    assert s["inner"].end_ns <= s["outer"].end_ns <= after
    assert {x.thread for x in got} == {threading.get_ident()}
    # perf_counter_ns is the clock time.perf_counter reads, onto which the
    # benchmark maps device events
    assert abs(time.perf_counter() * 1e9 - time.perf_counter_ns()) < 1e6
    with timing.span("next") as nxt:
        pass
    assert timing.spans()[-1].parent == -1 and nxt.id > outer.id


def test_each_thread_has_its_own_stack():
    ready, go = threading.Event(), threading.Event()

    def worker():
        with timing.span("worker"):
            ready.set()
            go.wait(5)
            with timing.span("worker.child"):
                pass

    with timing.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        assert ready.wait(5)
        with timing.span("main.child"):
            pass
        go.set()
        t.join(5)
    assert not t.is_alive()
    s = {x.name: x for x in timing.spans()}
    assert s["worker"].parent == -1 and s["worker.child"].parent == s["worker"].id
    assert s["main.child"].parent == s["main"].id and s["main"].parent == -1
    assert s["worker"].thread == s["worker.child"].thread != s["main"].thread


def test_the_ring_keeps_the_newest_and_counts_drops(monkeypatch):
    monkeypatch.setattr(timing, "_RING", timing._Ring(4))
    for i in range(6):
        timing.record(f"s{i}", 10 * i, 10 * i + 5, k=i)
    assert [s.name for s in timing.spans()] == ["s2", "s3", "s4", "s5"]
    assert [s.counts for s in timing.spans()] == [{"k": k} for k in (2, 3, 4, 5)]
    assert timing.drops() == (2, 15)
    assert [s.name for s in timing.spans(25, 40)] == ["s2", "s3", "s4"]
    # Time's registry shares the ring: its data is bounded too
    for ns in range(1, 10):
        timing.Time.save_with_name("t", ns)
    assert timing.Time.summaries() == {"t": pytest.approx(
        {"count": 4, "mean_ns": 7.5, "p50_ns": 7.5, "p99_ns": 8.97, "max_ns": 9.0})}
    assert timing.drops()[0] == 11
    timing.Time.reset()
    assert timing.drops() == (0, -1) and timing.spans() == []


def test_nothing_is_recorded_with_recording_off():
    timing.set_recording(False)
    with timing.span("off") as s:
        s.counts["n"] = 1
    timing.record("off", 1, 2)
    timing.Time.save_with_name("off", 5)
    timing.Time.start_with_name("off")
    assert timing.Time.stop_and_save_with_name("off") >= 0
    with timing.span("opened off"):
        timing.set_recording(True)  # closes cleanly: nothing was pushed
    assert timing.spans() == [] and timing.Time.summaries() == {}
    with timing.span("on"):
        pass
    assert [(s.name, s.parent) for s in timing.spans()] == [("on", -1)]


# -- the corpus scan ----------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "int16"])
def corpus_files(request, tmp_path_factory):
    """A net and three two-channel WAVs of one sample format, the second at
    48 kHz: float32 files are decoded on the host, 16-bit ones read
    straight into the host buffer."""
    folder = tmp_path_factory.mktemp("corpus")
    cfg = fixtures.pick_thresholds(fixtures.sample_geometry_config(3),
                                   fixtures.chirp_audio(1.0, 5))
    paths = []
    for i, rate in enumerate((44100, 48000, 44100)):
        x = np.stack([fixtures.chirp_audio(0.5 + 0.2 * i, 10 * i + c, rate) for c in range(2)], 1)
        paths.append(str(folder / f"f{i}.wav"))
        write_wav(paths[-1], x, rate, dtype=request.param)
    return cfg, paths


def read_straight_in(path) -> bool:
    """Whether the scan reads ``path``'s codes straight into its host buffer."""
    return _read_pcm16_into(path, bytearray(os.path.getsize(path))) is not None


def scan(cfg, paths, debounce_seconds=None, device="cpu"):
    lines = []
    corpus.scan_corpus_files(cfg, paths, debounce_seconds=debounce_seconds, emit=lines.append,
                             err=lambda s: None, method="fused", device=device)
    return lines


def test_corpus_scan_spans_count_what_the_scan_staged_walked_and_emitted(corpus_files):
    cfg, paths = corpus_files
    files, lanes = [], []  # each file's samples at its rate; each lane's at the net's
    for p in paths:
        x, rate = read_audio(p)
        files.append(x.size)
        if rate != cfg.sampling_rate:
            x = corpus.resample_channels(x, rate, cfg.sampling_rate, "cpu")
        lanes += [x.shape[0]] * x.shape[1]
    timing.Time.reset()
    lines, got = recorded(lambda: scan(cfg, paths))
    assert len(got) <= 40
    root, = named(got, "corpus.scan")
    assert got[-1] is root and all(s.parent == root.id for s in got[:-1])
    reads = named(got, "corpus.read")
    direct = int(read_straight_in(paths[0]))
    assert [s.counts for s in reads] == [{"direct": direct}] * 3
    assert [s.counts for s in named(got, "corpus.resample")] == [{"channels": 2}]
    # each file staged whole in the host buffer and uploaded once: a file
    # read straight in waits for its room before the read, a decoded one is
    # copied in after it; the batch is assembled on the device, behind the
    # last file
    stages, copies = named(got, "corpus.stage"), named(got, "corpus.copy_in")
    assert [s.counts for s in stages] == [
        {"lanes": 2, "samples": n, "staged_samples": n} for n in files]
    assert len(copies) == 4
    for read, stage, copy in zip(reads, stages, copies):
        assert in_order(stage, read, copy) if direct else in_order(read, stage, copy)
    steps = [copies[-1]] + [named(got, n)[0] for n in ("corpus.detect", "corpus.readback")]
    assert in_order(*steps) and len(got) == 3 + 3 + 4 + 1 + 2 + 6 + 1
    csv = named(got, "corpus.csv")
    evals = [max(0, num_frames(n, cfg.window_length, cfg.window_overlap) - cfg.time_range + 1)
             for n in lanes]
    assert [s.counts["rows"] for s in csv] == evals
    assert all(set(s.counts) == {"rows", "hits", "lines"} for s in csv)
    assert all(s.counts["hits"] == s.counts["lines"] for s in csv)  # no debounce
    detections = [line for line in lines if line not in paths]
    assert sum(s.counts["lines"] for s in csv) == len(detections) > 0
    # a debounce prints fewer of the same hits
    debounced, again = recorded(lambda: scan(cfg, paths, debounce_seconds=0.05))
    csv_d = named(again, "corpus.csv")
    assert [s.counts["hits"] for s in csv_d] == [s.counts["hits"] for s in csv]
    assert all(s.counts["hits"] >= s.counts["lines"] for s in csv_d)
    assert sum(s.counts["lines"] for s in csv_d) == len(
        [line for line in debounced if line not in paths]) < len(detections)
    timing.set_recording(False)
    assert scan(cfg, paths) == lines


def test_corpus_reads_count_the_files_read_straight_in(tmp_path):
    """Σ``direct`` over the ``corpus.read`` spans: every file of a 16-bit
    scan, two of three where the third is float32; the files' stages count
    their samples, nothing padded, and none overlaps a read."""
    cfg = fixtures.pick_thresholds(fixtures.sample_geometry_config(3),
                                   fixtures.chirp_audio(1.0, 5))
    paths = [str(tmp_path / f"m{i}.wav") for i in range(3)]
    for i, p in enumerate(paths):
        write_wav(p, fixtures.chirp_audio(0.3, 40 + i), 44100, dtype="int16")
    shares = []
    for _ in range(2):
        _, got = recorded(lambda: scan(cfg, paths))
        reads, stages = named(got, "corpus.read"), named(got, "corpus.stage")
        shares.append(sum(s.counts["direct"] for s in reads) / len(reads))
        assert len(stages) == 3 and all(
            in_order(a, b) or in_order(b, a) for a in reads for b in stages)
        assert sum(s.counts["samples"] for s in stages) == sum(
            s.counts["staged_samples"] for s in stages) == 3 * len(fixtures.chirp_audio(0.3))
        write_wav(paths[2], fixtures.chirp_audio(0.3, 42), 44100, dtype="float32")
    assert shares == [1.0, pytest.approx(2 / 3)]


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_corpus_scan_stages_its_lanes_at_the_longest_stream(method):
    """Lanes of four lengths are each staged once, padded nowhere on the
    host (the batch takes the longest, rounded up to 4 samples, on the
    device), and each lane's outputs equal, bit for bit, those of the same
    streams zero-padded to the power-of-two bucket the scan used to take,
    through the same plain path."""
    cfg = fixtures.pick_thresholds(fixtures.sample_geometry_config(3),
                                   fixtures.chirp_audio(1.0, 5))
    streams = [fixtures.chirp_audio(s, 30 + i) for i, s in enumerate((0.6, 0.37, 0.5, 0.91))]
    longest = max(map(len, streams))
    assert longest % 4  # the rounding is exercised
    got, spans = recorded(lambda: corpus.scan_corpus(cfg, streams, method=method, device="cpu"))
    assert [s.counts for s in named(spans, "corpus.stage")] == [
        {"lanes": 1, "samples": len(s), "staged_samples": len(s)} for s in streams]
    bucket = 1 << max(14, (longest - 1).bit_length())
    padded = np.zeros((4, bucket), np.float32)
    for row, s in zip(padded, streams):
        row[: len(s)] = s
    spec, params = corpus._spec_cache(cfg, torch.device("cpu"))
    want = corpus.batch_offline_outputs_shared(spec, params, torch.from_numpy(padded), method)
    for g, w, s in zip(got, want.numpy(), streams):
        evals = num_frames(len(s), cfg.window_length, cfg.window_overlap) - cfg.time_range + 1
        assert g.shape == (evals, 1) and evals > 50
        np.testing.assert_array_equal(g, w[:evals])


@pytest.fixture(scope="module", params=["float32", "int16"])
def card_files(request, tmp_path_factory):
    """On a card: a net and three two-channel WAVs of one sample format, of
    2**18 frames, at 48 and 96 kHz (resampled by the scan) and at the net's
    44.1 kHz."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused kernel and the resampler run only there)")
    folder = tmp_path_factory.mktemp("card")
    cfg = fixtures.pick_thresholds(fixtures.sample_geometry_config(4),
                                   fixtures.chirp_audio(1.0, 6))
    paths = []
    for i, rate in enumerate((48000, 96000, 44100)):
        x = np.stack([fixtures.chirp_audio(1 + 2**18 / rate, 20 * i + c, rate)[: 2**18]
                      for c in range(2)], 1)
        paths.append(str(folder / f"c{i}.wav"))
        write_wav(paths[-1], x, rate, dtype=request.param)
    return cfg, paths


def copy_bytes(fn, path, kind="DtoH") -> list[int]:
    """The bytes of each copy of ``kind`` (``DtoH``, ``HtoD``) in a
    ``torch.profiler`` trace of ``fn()``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [int(e["args"]["bytes"]) for e in events
            if e.get("cat") == "gpu_memcpy" and kind in e["name"]]


@pytest.mark.cuda
def test_card_scan_batch_equals_the_numpy_route_and_reads_back_only_outputs(
        card_files, monkeypatch, tmp_path):
    """On the card, the files' route (each file uploaded once, resampled and
    written into the batch there) gives the batch and K1 outputs of numpy
    streams, read, resampled to numpy and scanned, bit for bit; the only
    copy back to the host is the outputs'; and each file crosses to the card
    in one copy, of its 16-bit codes where it holds them (2 bytes a sample),
    of its float32 samples otherwise."""
    cfg, paths = card_files
    seen = []
    batch = corpus.batch_offline_outputs_shared

    def keep(spec, params, xs, method="matmul"):
        out = batch(spec, params, xs, method)
        seen.append((xs.clone(), out.clone()))
        return out

    monkeypatch.setattr(corpus, "batch_offline_outputs_shared", keep)
    streams = []
    for p in paths:
        x, rate = read_audio(p)
        if rate != cfg.sampling_rate:
            x = corpus.resample_channels(x, rate, cfg.sampling_rate, "cuda")
            assert isinstance(x, np.ndarray)
        streams += [np.ascontiguousarray(x[:, c]) for c in range(x.shape[1])]
    corpus.scan_corpus(cfg, streams, method="fused", device="cuda")
    lines = scan(cfg, paths, device="cuda")
    (xs_np, out_np), (xs_files, out_files) = seen
    longest = max(map(len, streams))
    assert xs_files.shape == (6, -(-longest // 4) * 4) and xs_files.is_cuda
    assert torch.equal(xs_files, xs_np)
    np.testing.assert_array_equal(out_files.cpu().numpy(), out_np.cpu().numpy())
    assert any(line not in paths for line in lines)
    copy_bytes(lambda: scan(cfg, paths, device="cuda"), tmp_path / "warm.json")
    copies = copy_bytes(lambda: scan(cfg, paths, device="cuda"), tmp_path / "scan.json")
    assert copies == [out_files.numel() * 4]
    itemsize = 2 if read_straight_in(paths[0]) else 4
    uploads = copy_bytes(lambda: scan(cfg, paths, device="cuda"), tmp_path / "in.json", "HtoD")
    # the files' copies, beside whatever small constants the launches upload
    assert sorted(u for u in uploads if u > 1 << 16) == [2**18 * 2 * itemsize] * 3, uploads


# -- the train CLI and the trainer ---------------------------------------------


def write_labeled(folder):
    audio, intervals = make_labeled_audio(seconds=2.0, seed=3)
    write_wav(folder / "a.wav", audio, 44100, dtype="float32")
    (folder / "l.csv").write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
    return folder


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    return write_labeled(tmp_path_factory.mktemp("train"))


def train_spans(folder, *flags, device="cpu"):
    argv = ["-a", str(folder / "a.wav"), "-l", str(folder / "l.csv"), "-o",
            str(folder / "net.txt"), "--hidden", "2", "--batch-size", "64",
            "--device", device, *flags]
    with contextlib.redirect_stdout(io.StringIO()):
        rc, got = recorded(lambda: ptrain.main(argv))
    assert rc == 0
    return got


TRAIN_SPANS = ["train.read", "train.features", "trainer.chain_fit", "trainer.indices",
               "trainer.device_wait", "trainer.pick", "train.trainer", "train.export"]


@pytest.mark.parametrize("epochs", [2, 9])
def test_quiet_train_main_spans_do_not_grow_with_epochs(labeled, epochs):
    got = train_spans(labeled, "--epochs", str(epochs), "--quiet")
    assert [s.name for s in got] == TRAIN_SPANS and len(got) <= 30
    trainer, = named(got, "train.trainer")
    assert all(s.parent == trainer.id for s in got if s.name.startswith("trainer."))
    assert all(s.parent == -1 for s in got if s.name.startswith("train."))
    assert named(got, "trainer.indices")[0].counts == {"epochs": epochs}
    assert in_order(*(named(got, n)[0] for n in TRAIN_SPANS[2:6]))


@pytest.mark.parametrize("flags,calls", [
    ([], [1, 1, 1, 1]),  # printing: one epoch a call
    (["--quiet", "--checkpoint-every", "2"], [2, 2]),
])
def test_only_the_index_draws_repeat_per_epoch_call(labeled, tmp_path, flags, calls):
    if "--checkpoint-every" in flags:
        flags = flags + ["--checkpoint-dir", str(tmp_path / "ckpt")]
    got = train_spans(labeled, "--epochs", "4", *flags)
    indices = named(got, "trainer.indices")
    assert [s.counts["epochs"] for s in indices] == calls
    assert sorted(s.name for s in got if s.name != "trainer.indices") == sorted(
        n for n in TRAIN_SPANS if n != "trainer.indices")


@pytest.mark.cuda
def test_train_main_captures_once_and_replays_each_epoch_on_card(labeled):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the epoch graph is a CUDA graph)")
    check_card_train_spans(labeled)


def check_card_train_spans(folder):
    """On the card: one capture of one graph, one enqueue of every epoch's
    replay, between the index draws and the wait for the device."""
    got = train_spans(folder, "--epochs", "5", "--quiet", device="cuda")
    capture, = named(got, "trainer.capture")
    replays, = named(got, "trainer.replays")
    assert capture.counts == {"graphs": 1} and replays.counts == {"replays": 5}
    trainer, = named(got, "train.trainer")
    assert capture.parent == replays.parent == trainer.id and len(got) <= 30
    assert in_order(named(got, "trainer.indices")[0], capture, replays,
                    named(got, "trainer.device_wait")[0])


# -- the live round ------------------------------------------------------------


@pytest.mark.parametrize("batched", [True, False], ids=["bank", "per-lane"])
def test_live_rounds_record_the_queue_wait_and_the_bank_steps(batched):
    audio = [fixtures.chirp_audio(0.3, s) for s in (1, 2)]
    cfgs = [fixtures.pick_thresholds(fixtures.sample_geometry_config(s), a)
            for s, a in zip((1, 2), audio)]
    proc = processor.Processor(
        audio_io.SimulatedAudioInput(lambda c, s, n: audio[c][s : s + n], channels=2),
        [processor.ProcessorEntry(i, i, config=c) for i, c in enumerate(cfgs)],
        processor.CallbackOutput(lambda *a: None), device="cpu", batched=batched,
        bank_transfer_dtype="int16",
    )
    rounds = []  # each round's spans, from its queue wait on
    for start in range(0, len(audio[0]) - 128, 128):  # the live cell's blocks
        stamp = time.perf_counter_ns()
        proc.receive_audio_block(None, np.stack([a[start : start + 128] for a in audio]))
        if batched:
            proc._drain_all()
        else:
            for i in range(2):
                proc._drain_lane(i, proc._lanes[i])
        for s in timing.spans(stamp):
            if s.name == "processor.queue_wait":
                assert s.start_ns >= stamp
                rounds.append([])
            rounds[-1].append(s)
    assert len(rounds) == (1 if batched else 2) * (len(audio[0]) // 128)
    bank_steps = ["bank.stage", "bank.copy", "bank.launch", "bank.readback"]
    for got in rounds:
        wait, *inner, round_ = got
        assert wait.name == "processor.queue_wait" and wait.parent == -1
        assert wait.end_ns <= round_.start_ns and round_.name in ("process", "skip")
        assert [s.name for s in inner] == (bank_steps if batched and inner else [])
        assert all(s.parent == round_.id for s in inner) and in_order(*inner)
    assert {r[-1].name for r in rounds} == {"process", "skip"}
    if batched:
        assert any(len(r) == 6 for r in rounds)
    assert timing.Time.summaries()["process"]["count"] == sum(
        r[-1].name == "process" for r in rounds)
    # the live cell's 30 s window of rounds fits the ring with no drop
    most = max(rounds, key=len)
    assert len(most) <= 6 and len(most) * LIVE_ROUNDS <= timing.CAPACITY
    t = time.perf_counter_ns()
    for k in range(LIVE_ROUNDS):
        for s in most:
            timing.record(s.name, t + k, t + k)
    assert timing.drops() == (0, -1)
    assert len(timing.spans(t, t + LIVE_ROUNDS)) == LIVE_ROUNDS * len(most)


def test_a_simulated_capture_session_records_whole_rounds_on_the_worker():
    """The simulated device delivers on its own thread and the worker
    coalesces: every round on the worker is its queue wait (where a ring
    held new samples), whole bank steps inside it, and its end."""
    audio = [fixtures.chirp_audio(0.5, s) for s in (3, 4, 5)]
    cfgs = [fixtures.pick_thresholds(fixtures.sample_geometry_config(s), a)
            for s, a in zip((3, 4, 5), audio)]
    interface = audio_io.SimulatedAudioInput(
        lambda c, s, n: audio[c][s : s + n], channels=3, frame_size=128,
        total_samples=len(audio[0]))
    proc = processor.Processor(
        interface, [processor.ProcessorEntry(i, i, config=c) for i, c in enumerate(cfgs)],
        processor.CallbackOutput(lambda *a: None), device="cpu", batched=True)
    lo = time.perf_counter_ns()
    proc.set_up()
    assert interface.wait_until_done(timeout=60)
    proc.drain_pending(timeout=60)
    proc.tear_down()
    assert proc.drain_errors == 0
    got = timing.spans(lo)
    assert {s.thread for s in got} == {got[-1].thread} != {threading.get_ident()}
    rounds, current = [], []
    for s in got:
        current.append(s)
        if s.name in ("process", "skip"):
            rounds.append(current)
            current = []
    assert not current and sum(r[-1].name == "process" for r in rounds) > 0
    steps = ["bank.stage", "bank.copy", "bank.launch", "bank.readback"]
    for *inner, round_ in rounds:
        if inner and inner[0].name == "processor.queue_wait":
            wait, *inner = inner
            assert wait.parent == -1 and wait.end_ns <= round_.start_ns
        names = [s.name for s in inner]
        assert names == steps * (len(names) // 4)
        assert all(s.parent == round_.id for s in inner) and in_order(*inner)
    assert timing.drops() == (0, -1)
