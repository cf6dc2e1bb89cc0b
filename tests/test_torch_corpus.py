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
import io

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
from test_torch_cli import assert_csv_close, run, run_jax, split_files

torch.set_num_threads(1)


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
    assert tcorpus._bucket(1) == 1 << 14 and tcorpus._bucket((1 << 15) + 1) == 1 << 16


BATCHED = {
    "matmul": ["--method", "matmul"],
    "fused": ["--method", "fused"],
    "nets": ["--method", "fused", "-n", "{net1}"],
    "groups": ["--method", "fused", "--batch-files", "1"],
}


@pytest.mark.parametrize("variant", list(BATCHED))
def test_batched_cli_matches_jax(corpus, variant, monkeypatch):
    _, _, p = corpus
    files = [p["two"], p["fast"], p["one"]]
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
    assert {line.split(",")[0] for line in got_f[p["two"]]} == {"0", "1"}
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


def test_cli_mesh_is_not_ported(corpus):
    _, _, p = corpus
    with pytest.raises(NotImplementedError, match="A8"):
        port_main(["-n", p["net0"], "-a", p["one"], "--batched", "--mesh", "--device", "cpu"])


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
