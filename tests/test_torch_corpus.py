"""The port's batched corpus scan, its resampling CLI and its simulator
against the JAX package's, on the CPU.

A corpus of three short files: a 2-channel file and a mono file at the
net's 44.1 kHz, and a mono file at 48 kHz that both CLIs resample. The
thresholds are picked on the audio the nets hear (the 48 kHz file
resampled), at least 1e-3 from every output, so no decision can flip
between implementations that agree within tolerance. CSV columns 1-3 must
match exactly and outputs within rtol=1e-4, atol=1e-5 (the contract of
tests/test_cli_golden.py); raw outputs of the fused path within the JAX
fused kernel's own bound against its unfused path (rtol=1e-3, atol=2e-4).
The JAX side always runs its unfused path: its fused kernel would run in
Pallas interpret mode here.
"""

import contextlib
import dataclasses
import io
import pathlib
import struct
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import syllable_detector_tpu.corpus as jcorpus
import syllable_detector_tpu.sim as jsim
from syllable_detector_tpu.config.model_format import save_config
from syllable_detector_tpu.utils.wav import read_audio, write_wav
from syllable_detector_tpu_torch import corpus as tcorpus
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch import sim as tsim
from syllable_detector_tpu_torch.cli import main as port_main
from syllable_detector_tpu_torch.ops.resample import polyphase_resample
from syllable_detector_tpu_torch.ops.stft import num_frames
from syllable_detector_tpu_torch.parallel import mesh as pmesh
from syllable_detector_tpu_torch.utils import timing
from syllable_detector_tpu_torch.utils import wav as twav
from test_torch_cli import assert_csv_close, run, run_jax, split_files

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    two = np.stack([fixtures.chirp_audio(0.6, 41), fixtures.chirp_audio(0.6, 42)], 1)
    fast = fixtures.chirp_audio(0.5, 43, rate=48000)
    one = fixtures.chirp_audio(0.3, 44)
    heard = polyphase_resample(fast, 48000, 44100, device="cpu").numpy()
    audio = np.concatenate([two.reshape(-1), heard, one])
    cfgs = [fixtures.pick_thresholds(fixtures.sample_geometry_config(s), audio) for s in (51, 52)]
    p = {name: str(d / f"{name}.wav") for name in ("two", "fast", "one")}
    write_wav(p["two"], two, 44100, dtype="float32")
    write_wav(p["fast"], fast, 48000, dtype="float32")
    write_wav(p["one"], one, 44100, dtype="float32")
    for name in ("two", "fast", "one"):  # 16-bit copies, read straight in by the port
        x, rate = read_audio(p[name])
        p[name + "16"] = str(d / f"{name}16.wav")
        write_wav(p[name + "16"], x, rate, dtype="int16")
    for i, cfg in enumerate(cfgs):
        p[f"net{i}"] = str(d / f"net{i}.txt")
        save_config(cfg, p[f"net{i}"])
    streams = [two[:, 0], two[:, 1], heard, one]
    return cfgs, streams, p


def close(got, want, fused):
    rtol, atol = (1e-3, 2e-4) if fused else (1e-4, 1e-5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", ["matmul", "fused"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
def test_scan_corpus_matches_jax(corpus, method, per_lane):
    cfgs, streams, _ = corpus
    lane_cfgs = [cfgs[i % 2] for i in range(len(streams))] if per_lane else None
    got = tcorpus.scan_corpus(cfgs[0], streams, method=method, lane_configs=lane_cfgs, device="cpu")
    want = jcorpus.scan_corpus(cfgs[0], streams, method="matmul", lane_configs=lane_cfgs)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 50
        close(g, w, method == "fused")
    assert np.isnan(got[0]).any()  # the chirp's stretch of digital silence
    assert tcorpus.scan_corpus(cfgs[0], [], device="cpu") == []
    with pytest.raises(ValueError, match="lane networks"):
        tcorpus.scan_corpus(cfgs[0], streams, lane_configs=cfgs, device="cpu")


def test_scan_corpus_checks_lane_geometry(corpus):
    cfgs, streams, _ = corpus
    with pytest.raises(ValueError, match="share the first network's geometry"):
        tcorpus.scan_corpus(cfgs[0], streams[:2], lane_configs=[cfgs[0], fixtures.gap_config()], device="cpu")


@pytest.mark.parametrize("method", ["matmul", "fused"])
@pytest.mark.parametrize("form", ["tensors", "mixed"])
def test_scan_corpus_takes_streams_as_tensors_or_numpy(corpus, method, form, monkeypatch):
    """Streams given as tensors on the device (copied into the batch there),
    or some of them as numpy (each staged in the host buffer and uploaded
    first), give the outputs of numpy streams bit for bit, with every tensor the scan makes
    by ``torch.empty`` filled with NaN first (the host buffer's bytes with
    0xFF, NaN as float32): nothing reads what it did not write."""
    cfgs, streams, _ = corpus
    want = tcorpus.scan_corpus(cfgs[0], streams, method=method, device="cpu")
    given = [torch.from_numpy(s) if form == "tensors" or i % 2 else s
             for i, s in enumerate(streams)]
    empty = torch.empty

    def poisoned(*args, **kwargs):
        t = empty(*args, **kwargs)
        if t.dtype == torch.uint8:  # the host buffer: NaN read as float32
            return t.fill_(255)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", poisoned)
    tcorpus._host_buffers.clear()
    got = tcorpus.scan_corpus(cfgs[0], given, method=method, device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 50
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shards", [None, 3], ids=["unsharded", "mesh3"])
@pytest.mark.parametrize("form", ["numpy", "tensors"])
def test_scan_corpus_batch_holds_each_stream_then_zeros(corpus, form, shards, monkeypatch):
    """The batch handed to detection is ``[lanes, L]``, ``L`` the longest
    stream rounded up to 4: each lane holds its stream, then zeros, and a
    mesh's padding lanes hold zeros, though every tensor the scan makes by
    ``torch.empty`` starts as NaN (the host buffer's bytes as 0xFF)."""
    cfgs, streams, _ = corpus
    given = [torch.from_numpy(s) for s in streams] if form == "tensors" else streams
    empty = torch.empty

    def poisoned(*args, **kwargs):
        t = empty(*args, **kwargs)
        if t.dtype == torch.uint8:  # the host buffer: NaN read as float32
            return t.fill_(255)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    batches = []
    plain, sharded = tcorpus.batch_offline_outputs_shared, tcorpus.sharded_batch_offline_outputs_shared
    monkeypatch.setattr(torch, "empty", poisoned)
    monkeypatch.setattr(tcorpus, "batch_offline_outputs_shared",
                        lambda spec, params, xs, method: batches.append(xs.clone())
                        or plain(spec, params, xs, method))
    monkeypatch.setattr(tcorpus, "sharded_batch_offline_outputs_shared",
                        lambda mesh, spec, params, xs, method: batches.append(xs.clone())
                        or sharded(mesh, spec, params, xs, method))
    tcorpus._host_buffers.clear()
    mesh = None if shards is None else pmesh.make_mesh(shards, devices=["cpu"])
    got = tcorpus.scan_corpus(cfgs[0], given, mesh=mesh, device="cpu")
    batch, = batches
    lanes = len(streams) if shards is None else 6
    want = np.zeros((lanes, -(-max(map(len, streams)) // 4) * 4), np.float32)
    for row, s in zip(want, streams):
        row[: len(s)] = s
    np.testing.assert_array_equal(batch.numpy(), want)
    assert [len(g) for g in got] == [
        num_frames(len(s), cfgs[0].window_length, cfgs[0].window_overlap)
        - cfgs[0].time_range + 1 for s in streams]


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_scan_corpus_takes_one_route_for_every_stream_kind(corpus, method, monkeypatch):
    """Numpy streams and CPU tensors of the same samples reach detection as
    one batch, bit for bit, and give the same outputs: each numpy stream is
    staged once, padded nowhere (a ``corpus.stage`` whose ``staged_samples``
    are its samples), and the batch is then built on the device as it is
    from tensors already there, which stage nothing."""
    cfgs, streams, _ = corpus
    batches, plain = [], tcorpus.batch_offline_outputs_shared
    monkeypatch.setattr(tcorpus, "batch_offline_outputs_shared",
                        lambda spec, params, xs, method: batches.append(xs.clone())
                        or plain(spec, params, xs, method))
    lo = time.perf_counter_ns()
    from_numpy = tcorpus.scan_corpus(cfgs[0], streams, method=method, device="cpu")
    mid = time.perf_counter_ns()
    tensors = [torch.from_numpy(np.ascontiguousarray(s)) for s in streams]
    from_tensors = tcorpus.scan_corpus(cfgs[0], tensors, method=method, device="cpu")
    hi = time.perf_counter_ns()
    stages = [[sp.counts for sp in timing.spans(a, b) if sp.start_ns >= a
               and sp.name == "corpus.stage"] for a, b in ((lo, mid), (mid, hi))]
    assert stages == [[{"lanes": 1, "samples": len(s), "staged_samples": len(s)}
                       for s in streams], []]
    assert len(batches) == 2 and torch.equal(batches[0], batches[1])
    assert len(from_numpy) == len(from_tensors) == 4
    for g, w in zip(from_tensors, from_numpy):
        assert g.shape == w.shape and len(g) > 50
        np.testing.assert_array_equal(g, w)


FRESH_SCAN = """
import sys
import numpy as np
import torch
from syllable_detector_tpu_torch import corpus
from syllable_detector_tpu_torch.config.model_format import load_config
torch.set_num_threads(1)
streams = list(np.load(sys.argv[1]).values())
batches, plain = [], corpus.batch_offline_outputs_shared
corpus.batch_offline_outputs_shared = lambda *a: batches.append(a[2].clone()) or plain(*a)
outs = corpus.scan_corpus(load_config(sys.argv[2]), streams, method=sys.argv[3], device="cpu")
np.savez(sys.argv[4], batches[0].numpy(), *outs)
"""


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_scan_corpus_reuses_its_host_buffer_without_stale_samples(corpus, method, tmp_path,
                                                                  monkeypatch):
    """A scan after a longer and wider one refills the same host buffer: its
    batch and outputs equal, bit for bit, those of a fresh process, so the
    tails of its shorter lanes hold zeros, not the first scan's samples."""
    cfgs, streams, p = corpus
    wide = [fixtures.chirp_audio(0.9, 60 + i) for i in range(6)]
    tcorpus.scan_corpus(cfgs[0], wide, method=method, device="cpu")
    buffer = tcorpus._host_buffers["cpu"].buf
    assert buffer.numel() == tcorpus._FILE_ROOMS * tcorpus._aligned(len(wide[0]) * 4)
    batches, plain = [], tcorpus.batch_offline_outputs_shared
    monkeypatch.setattr(tcorpus, "batch_offline_outputs_shared",
                        lambda *a: batches.append(a[2].clone()) or plain(*a))
    got = tcorpus.scan_corpus(cfgs[0], streams, method=method, device="cpu")
    assert tcorpus._host_buffers["cpu"].buf is buffer  # reused, not reallocated
    np.savez(tmp_path / "streams.npz", *streams)
    subprocess.run([sys.executable, "-c", FRESH_SCAN, str(tmp_path / "streams.npz"), p["net0"],
                    method, str(tmp_path / "fresh.npz")], cwd=REPO, check=True, timeout=300)
    fresh_batch, *fresh = np.load(tmp_path / "fresh.npz").values()
    np.testing.assert_array_equal(batches[0].numpy(), fresh_batch)
    assert len(got) == len(fresh) == 4
    for g, w in zip(got, fresh):
        assert g.shape == w.shape and len(g) > 50
        np.testing.assert_array_equal(g, w)


def _fmt(channels, bits, code=1, rate=44100, extensible=False, align=None):
    """A ``fmt `` payload; WAVE_FORMAT_EXTENSIBLE carries ``code`` in its
    subformat GUID."""
    align = channels * bits // 8 if align is None else align
    base = struct.pack("<HHIIHH", 0xFFFE if extensible else code, channels, rate, rate * align,
                       align, bits)
    if not extensible:
        return base
    guid = struct.pack("<H", code) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    return base + struct.pack("<HHI", 22, bits, 0) + guid


def _riff(*chunks):
    """RIFF/WAVE bytes of ``(id, payload[, claimed size])`` chunks, each
    followed by its pad byte where its payload is odd; a chunk that claims
    more than its payload must come last."""
    body = b"WAVE"
    for cid, payload, *claimed in chunks:
        size = claimed[0] if claimed else len(payload)
        body += cid + struct.pack("<I", size) + payload + b"\x00" * (len(payload) % 2)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _codes(frames, channels, seed=0):
    """Seeded int16 codes ``[frames, channels]`` with both extremes in them."""
    c = np.random.default_rng(seed).integers(-32768, 32768, (frames, channels)).astype("<i2")
    c.flat[:2] = (-32768, 32767)
    return c


def _int24(x):
    """``[n, channels]`` signed 24-bit codes as little-endian bytes."""
    return (x.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]).tobytes()


def _audio_file(kind, folder):
    """(path, whether the file's codes go straight into the host buffer, or
    None where the read must fail) of a file of ``kind``."""
    path = folder / f"{kind}.wav"
    pcm = lambda ch, frames=1000: _codes(frames, ch, len(kind)).tobytes()  # noqa: E731
    data = {
        "mono": _riff((b"fmt ", _fmt(1, 16)), (b"data", pcm(1))),
        "stereo": _riff((b"fmt ", _fmt(2, 16)), (b"data", pcm(2))),
        "three_odd_frames": _riff((b"fmt ", _fmt(3, 16, rate=48000)), (b"data", pcm(3, 777))),
        "cut_mid_frame": _riff((b"fmt ", _fmt(2, 16)), (b"data", pcm(2) + b"\x01\x02\x03")),
        "claims_more": _riff((b"fmt ", _fmt(2, 16)), (b"data", pcm(2) + b"\x05", 10**6)),
        "list_around": _riff((b"LIST", b"INFOISFT\x04\x00\x00\x00sd\x00\x00"),
                             (b"fmt ", _fmt(2, 16)), (b"data", pcm(2)),
                             (b"LIST", b"INFOICMT\x02\x00\x00\x00x\x00")),
        "odd_chunk_pad": _riff((b"fmt ", _fmt(1, 16)), (b"junk", b"\x07" * 5), (b"data", pcm(1))),
        "fmt_after_data": _riff((b"data", pcm(2)), (b"fmt ", _fmt(2, 16, rate=96000))),
        "two_data_last_wins": _riff((b"fmt ", _fmt(1, 16)), (b"data", pcm(1, 5)),
                                    (b"data", pcm(1, 9))),
        "extensible": _riff((b"fmt ", _fmt(2, 16, extensible=True)), (b"data", pcm(2))),
        "pcm8": _riff((b"fmt ", _fmt(2, 8)), (b"data", bytes(range(256)) * 8)),
        "pcm24": _riff((b"fmt ", _fmt(2, 24)),
                       (b"data", _int24(_codes(1000, 2).astype(np.int32) * 256 + 17))),
        "pcm32": _riff((b"fmt ", _fmt(2, 32)),
                       (b"data", (_codes(1000, 2).astype("<i4") * 65536 + 3).tobytes())),
        "extensible_float": _riff((b"fmt ", _fmt(1, 32, code=3, extensible=True)),
                                  (b"data", np.linspace(-1, 1, 999, dtype="<f4").tobytes())),
        "bad_align": _riff((b"fmt ", _fmt(2, 16, align=6)), (b"data", pcm(2))),
        "no_data": _riff((b"fmt ", _fmt(2, 16))),
        "truncated_header": b"RIFF\x10\x00",
    }.get(kind)
    if kind == "float32":
        write_wav(path, _codes(1000, 2) / 32768.0, 44100, dtype="float32")
    elif kind == "aiff":
        path = folder / "a.aiff"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            import aifc
        f = aifc.open(str(path), "wb")
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(22050)
        f.writeframes(_codes(1000, 2).astype(">i2").tobytes())
        f.close()
    elif kind == "missing":
        path = folder / "missing.wav"
    else:
        path.write_bytes(data)
    direct = {"pcm8": False, "pcm24": False, "pcm32": False, "float32": False, "aiff": False,
              "extensible_float": False}.get(kind, True)
    return path, None if kind in ("bad_align", "no_data", "truncated_header", "missing") else direct


AUDIO_KINDS = ["mono", "stereo", "three_odd_frames", "cut_mid_frame", "claims_more",
               "list_around", "odd_chunk_pad", "fmt_after_data", "two_data_last_wins",
               "extensible", "pcm8", "pcm24", "pcm32", "float32", "extensible_float", "aiff",
               "bad_align", "no_data", "truncated_header", "missing"]


@pytest.mark.parametrize("kind", AUDIO_KINDS)
def test_file_to_device_reads_16_bit_pcm_straight_in_as_read_audio_decodes_it(kind, tmp_path):
    """A 16-bit PCM WAV's codes go straight into the host buffer (``direct``
    1 on its ``corpus.read`` span) and come out as the JAX package's
    ``read_audio`` float32 samples, bit for bit, with its rate; any other
    file takes the fallback (``direct`` 0) and gives that reader's result;
    a file it refuses gives the scan's ``Unable to read`` line with its
    message. The port's ``read_audio`` agrees with it on every kind."""
    path, direct = _audio_file(kind, tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, port = [], []
        for reader, into in ((read_audio, want), (twav.read_audio, port)):
            try:
                into.extend(reader(str(path)))
            except (OSError, ValueError) as e:
                into.append(e)
        want, want_rate = want if len(want) == 2 else (want[0], None)
        lo = time.perf_counter_ns()
        try:
            got, rate = tcorpus._file_to_device(str(path), torch.device("cpu"),
                                                tcorpus._file_size(path))
        except (OSError, ValueError) as e:
            got = e
        errors = []
        tcorpus.scan_corpus_files(fixtures.sample_geometry_config(0), [str(path)],
                                  emit=lambda s: None, err=errors.append, device="cpu")
    read, *_ = [s for s in timing.spans(lo) if s.name == "corpus.read"]
    if direct is None:
        assert isinstance(want, (OSError, ValueError)) and type(got) is type(want)
        assert str(got) == str(want) == str(port[0]) and type(port[0]) is type(want)
        assert errors == [f"Unable to read {path}: {want}"]
        assert read.counts == {"direct": 0}
        return
    assert read.counts == {"direct": int(direct)}
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert rate == want_rate and tuple(got.shape) == want.shape and len(want) > 0
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert port[1] == want_rate  # the port's own reader, on the walk it shares
    np.testing.assert_array_equal(port[0].view(np.int32), want.view(np.int32))
    if kind == "two_data_last_wins":
        assert len(want) == 9
    if kind in ("cut_mid_frame", "claims_more"):
        assert len(want) == 1000


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_scan_corpus_files_reads_pcm16_straight_in_and_writes_the_fallback_s_lines(
        method, tmp_path, monkeypatch):
    """Two scans in a row of a 16-bit file at the net's rate, a 16-bit file
    to be resampled and a 24-bit file give the CSV lines of a scan that
    decodes every file on the host, line for line; the first two files'
    reads are direct, the third's not, and the second scan refills the
    host buffer the first one grew, without reallocating it."""
    two = np.stack([fixtures.chirp_audio(0.6, 81), fixtures.chirp_audio(0.6, 82)], 1)
    fast = fixtures.chirp_audio(0.5, 83, rate=48000)
    wide = np.stack([fixtures.chirp_audio(0.4, 84), fixtures.chirp_audio(0.4, 85)], 1)
    paths = [str(tmp_path / n) for n in ("two.wav", "fast.wav", "wide.wav")]
    write_wav(paths[0], two, 44100)
    write_wav(paths[1], fast, 48000)
    codes24 = np.clip(np.round(wide * 2**23), -(2**23), 2**23 - 1).astype(np.int32)
    pathlib.Path(paths[2]).write_bytes(_riff((b"fmt ", _fmt(2, 24)), (b"data", _int24(codes24))))
    heard = polyphase_resample(fast, 48000, 44100, device="cpu").numpy()
    cfg = fixtures.pick_thresholds(fixtures.sample_geometry_config(54),
                                   np.concatenate([two.reshape(-1), heard, wide.reshape(-1)]))

    def scan():
        lines, lo = [], time.perf_counter_ns()
        tcorpus.scan_corpus_files(cfg, paths, emit=lines.append, err=lambda s: None,
                                  method=method, device="cpu")
        reads = [s.counts["direct"] for s in timing.spans(lo) if s.name == "corpus.read"]
        return lines, reads

    tcorpus._host_buffers.clear()
    first, reads = scan()
    buffer = tcorpus._host_buffers["cpu"].buf
    second, again = scan()
    assert tcorpus._host_buffers["cpu"].buf is buffer  # reused, not reallocated
    # three rooms of the largest block staged: the 24-bit file's float32 samples
    assert buffer.numel() == tcorpus._FILE_ROOMS * tcorpus._aligned(wide.size * 4)
    assert reads == again == [1, 1, 0]
    monkeypatch.setattr(tcorpus, "_read_pcm16_into", lambda path, buffer: None)
    fallback, none = scan()
    assert none == [0, 0, 0]
    assert first == second == fallback
    assert sum(line not in paths for line in first) > 0


@pytest.mark.parametrize("seed", range(3))
def test_host_ring_keeps_each_room_off_the_one_before(seed):
    """Rooms of up to the largest size the ring was fitted to start on
    64 bytes, lie inside the buffer and never overlap the room before, so a
    file's read never waits on the upload of the file before it; the buffer
    is not grown."""
    sizes = np.random.default_rng(seed).integers(0, 10_000, 300)
    cpu, ring = torch.device("cpu"), tcorpus._HostRing()
    ring.reserve(cpu, int(sizes.max()))
    buffer, before = ring.buf, (0, 0)
    for n in map(int, sizes):
        room = ring.room(cpu, n)
        at = room.data_ptr() - buffer.data_ptr()
        assert room.numel() == n and at % tcorpus._ALIGN == 0 and at + n <= buffer.numel()
        assert at >= before[1] or at + n <= before[0]
        before = (at, at + n)
    assert ring.buf is buffer


def test_resample_channels_returns_what_it_was_given(corpus):
    """numpy in, numpy out; a tensor in, a tensor on the device out; the same
    float32 values, each channel the polyphase resampler's."""
    x = np.stack([fixtures.chirp_audio(0.4, 70), fixtures.chirp_audio(0.4, 71)], 1)
    got_np = tcorpus.resample_channels(x, 48000, 44100, "cpu")
    got_t = tcorpus.resample_channels(torch.from_numpy(x), 48000, 44100, "cpu")
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    assert got_np.dtype == np.float32 and got_t.dtype == torch.float32
    assert got_np.shape == tuple(got_t.shape) == (-(-len(x) * 147 // 160), 2)
    np.testing.assert_array_equal(got_t.numpy(), got_np)
    for c in range(2):
        want = polyphase_resample(np.ascontiguousarray(x[:, c]), 48000, 44100, device="cpu")
        np.testing.assert_array_equal(got_np[:, c], want.numpy())


def _runs(rng, n, run, gap, value=1.0):
    """[n, 1] zeros with runs of ``run`` rows at ``value``, ``gap`` rows apart."""
    out = np.zeros((n, 1), np.float32)
    for start in range(int(rng.integers(0, gap)), n, run + gap):
        out[start : start + run] = value
    return out


def _csv_case(name, rng):
    """(config, [E, O] float32 outputs, channel, debounce in samples)."""
    cfg = fixtures.sample_geometry_config(0)
    hop = cfg.window_length - cfg.window_overlap
    u = lambda e, o: rng.random((e, o)).astype(np.float32)  # noqa: E731
    if name == "o1":
        return dataclasses.replace(cfg, thresholds=[0.97]), u(3000, 1), 0, 0
    if name == "o3_per_output":
        return dataclasses.replace(cfg, thresholds=[0.99, 0.95, 1.5]), u(3000, 3), 2, hop
    if name == "nonfinite":
        out = u(3000, 3)
        for col, v in ((0, np.nan), (1, np.inf), (2, -np.inf), (0, -np.inf)):
            out[rng.choice(3000, 200, replace=False), col] = v
        out[rng.choice(3000, 50, replace=False)] = np.nan
        return dataclasses.replace(cfg, thresholds=[0.95, 0.98, 0.9]), out, 1, 0
    if name == "first_and_last_row":
        out = np.zeros((500, 1), np.float32)
        out[[0, 17, 499]] = 0.75
        return cfg, out, 0, 0
    if name == "debounce_one_hop":
        return dataclasses.replace(cfg, thresholds=[0.5]), _runs(rng, 3000, 7, 5), 0, hop
    if name == "debounce_past_a_run":
        return cfg, _runs(rng, 3000, 6, 9), 3, 11 * hop + 5
    if name == "float64_compare":  # float32(0.7) < 0.7 in float64
        out = np.full((400, 2), np.float32(0.7))
        out[rng.choice(400, 30, replace=False), 1] = np.nextafter(np.float32(0.7), 1)
        return dataclasses.replace(cfg, thresholds=[0.7, 0.7]), out, 0, 0
    if name == "empty":
        return dataclasses.replace(cfg, thresholds=[0.5, 0.5]), u(0, 2), 0, hop
    if name == "yield_one":
        return dataclasses.replace(cfg, thresholds=[-1.0, 2.0]), u(700, 2), 1, 0
    if name == "yield_zero":
        return dataclasses.replace(cfg, thresholds=[1.0, 1.0]), u(3000, 2), 0, 0
    if name == "gap_geometry":
        return fixtures.gap_config(), _runs(rng, 3000, 4, 3), 0, 2 * fixtures.gap_config().hop
    assert name == "rate_48k"
    cfg48 = fixtures.geometry_config(0, rate=48000)
    return dataclasses.replace(cfg48, thresholds=[0.9]), u(3000, 1), 0, 3 * hop


CSV_CASES = ["o1", "o3_per_output", "nonfinite", "first_and_last_row", "debounce_one_hop",
             "debounce_past_a_run", "float64_compare", "empty", "yield_one", "yield_zero",
             "gap_geometry", "rate_48k"]


@pytest.mark.parametrize("name", CSV_CASES)
def test_corpus_csv_lines_match_jax_row_loop(name):
    """The port tests every row at once and walks only the rows over
    threshold; its lines equal the JAX row loop's byte for byte."""
    cfg, outputs, channel, debounce = _csv_case(name, np.random.default_rng(CSV_CASES.index(name)))
    got = tcorpus.corpus_csv_lines(cfg, outputs, channel=channel, debounce_frames=debounce)
    want = jcorpus.corpus_csv_lines(cfg, outputs, channel=channel, debounce_frames=debounce)
    assert got == want
    hits = int((outputs.astype(np.float64) >= np.asarray(cfg.thresholds)).any(axis=1).sum())
    if name in ("empty", "yield_zero"):
        assert got == [] and hits == 0
    elif name == "yield_one":
        assert len(got) == len(outputs)
    else:
        assert 0 < len(got) <= hits
        assert (len(got) < hits) == (debounce > 0)
    if name == "first_and_last_row":
        assert [int(line.split(",")[1]) for line in got] == [
            cfg.first_output_sample + (cfg.window_length - cfg.window_overlap) * k
            for k in (0, 17, 499)
        ]


BATCHED = {
    "matmul": ["--method", "matmul"],
    "fused": ["--method", "fused"],
    "nets": ["--method", "fused", "-n", "{net1}"],
    "groups": ["--method", "fused", "--batch-files", "1"],
    "int16": ["--method", "fused"],
}


@pytest.mark.parametrize("variant", list(BATCHED))
def test_batched_cli_matches_jax(corpus, variant, monkeypatch):
    _, _, p = corpus
    files = [p[name + ("16" if variant == "int16" else "")] for name in ("two", "fast", "one")]
    argv = ["-n", p["net0"], "-d", "0.02", "--batched"] + [a for f in files for a in ("-a", f)]
    extra = [a.format(**p) for a in BATCHED[variant]]
    rc, got, err = run(port_main, argv + extra + ["--device", "cpu"])
    jrc, want, jerr = run_jax(argv + extra[2:], monkeypatch)  # unfused, as said above
    assert rc == jrc == 0 and err == jerr and "Resampling" in err
    got_f, want_f = split_files(got, files), split_files(want, files)
    assert list(got_f) == list(want_f) == files
    for path in files:
        assert got_f[path], "fixture audio must trigger detections"
        assert_csv_close(got_f[path], want_f[path])
    assert {line.split(",")[0] for line in got_f[files[0]]} == {"0", "1"}
    if variant == "groups":
        ungrouped = run(port_main, argv + ["--method", "fused", "--device", "cpu"])[1]
        assert got == ungrouped


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_sequential_cli_resamples_like_jax(corpus, method, monkeypatch):
    _, _, p = corpus
    argv = ["-n", p["net0"], "-n", p["net1"], "-a", p["fast"]]
    rc, got, err = run(port_main, argv + ["--method", method, "--device", "cpu"])
    jrc, want, jerr = run_jax(argv, monkeypatch)
    assert rc == jrc == 0 and err == jerr
    assert err == f"Resampling {p['fast']} from 48000 Hz to the network rate 44100.0 Hz.\n"
    assert len(got) > 5
    assert_csv_close(got, want)
    # the batched scan of the same file gives the same lines (one channel,
    # shorter than the sequential chunk)
    batched = run(port_main, argv + ["--method", method, "--device", "cpu", "--batched"])[1]
    assert_csv_close(batched, got)


def test_cli_mesh_is_not_ported(corpus, monkeypatch):
    """``--mesh`` used to raise; it now shards the lanes (on the CPU: one
    shard) and gives the unsharded CSV and the JAX CLI's (the name is kept
    from the time it was not ported)."""
    _, _, p = corpus
    argv = ["-n", p["net0"], "-a", p["two"], "-a", p["fast"], "--batched"]
    rc, got, err = run(port_main, argv + ["--mesh", "--method", "fused", "--device", "cpu"])
    assert rc == 0 and "Mesh: 1 shard(s) on cpu." in err
    assert got == run(port_main, argv + ["--method", "fused", "--device", "cpu"])[1]
    jrc, want, _ = run_jax(argv + ["--mesh"], monkeypatch)
    assert jrc == 0 and len(got) == len(want) > 5
    files = [p["two"], p["fast"]]
    got_f, want_f = split_files(got, files), split_files(want, files)
    for path in files:
        assert_csv_close(got_f[path], want_f[path])


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_sim_matches_jax(corpus, method, tmp_path):
    cfgs, streams, p = corpus
    got = tsim.simulate(cfgs[0], streams[1], method=method, device="cpu")
    want = jsim.simulate(cfgs[0], streams[1], method="matmul")
    assert got.shape == want.shape == streams[1].shape
    assert 0 < np.count_nonzero(got == 1.0) < len(got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the entry points write the same detection-signal WAV
    out, jout = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    argv = ["-n", p["net0"], "-a", p["two"], "--channel", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert tsim.main(argv + ["-o", out, "--method", method, "--device", "cpu"]) == 0
        assert jsim.main(argv + ["-o", jout]) == 0
    (a, rate), (b, jrate) = read_audio(out), read_audio(jout)
    assert rate == jrate == 44100 and a.shape == b.shape == (len(streams[1]), 1)
    np.testing.assert_allclose(a, b, atol=2.0 / 32768)


def test_sim_errors(corpus, tmp_path):
    _, _, p = corpus
    argv = ["-n", p["net0"], "-a", p["one"], "-o", str(tmp_path / "o.wav")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsim.main(argv)
    with contextlib.redirect_stderr(io.StringIO()) as err:
        assert tsim.main(argv + ["--device", "cpu", "--channel", "3"]) == 1
        assert tsim.main(["-n", str(tmp_path / "none.txt")] + argv[2:] + ["--device", "cpu"]) == 1
    assert "No channel 3" in err.getvalue() and "Unable to load" in err.getvalue()
