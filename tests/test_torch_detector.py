"""The port's streaming Detector against whole-stream evaluation, against
itself across drain methods, and against the JAX package's Detector on the
same chunks, including a state handed over mid-stream.

Tolerances: rtol=1e-5, atol=1e-6 where one implementation only batches the
same arithmetic differently; the CLI's rtol=1e-4, atol=1e-5 between the
port and the JAX package on the unfused path; the fused kernel's
rtol=1e-3, atol=2e-4 wherever a fused path meets an unfused one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.config.model_format import ProcessingSpec
from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.models import detector as tdet

torch.set_num_threads(1)

CHUNKS = [1, 4097, 17, 9000, 133, 30000, 2]


@pytest.fixture(scope="module")
def cfg():
    return fixtures.sample_geometry_config(5)


@pytest.fixture(scope="module")
def audio():
    return fixtures.chirp_audio(0.6, seed=6)


def feed(det, x, sizes=CHUNKS):
    """Append ``x`` in chunks of ``sizes`` (cycled), draining after each."""
    outs, pos, i = [], 0, 0
    while pos < len(x):
        det.append_audio_data(x[pos : pos + sizes[i % len(sizes)]])
        pos += sizes[i % len(sizes)]
        i += 1
        outs.append(np.asarray(det.drain()))
    return np.concatenate(outs)


def close(got, want, rtol, atol):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", ["matmul", "rfft", "fused"])
def test_chunk_sizes_do_not_change_outputs(cfg, audio, method):
    whole = tdet.Detector(cfg, method=method, device="cpu")
    whole.append_audio_data(audio)
    want = whole.drain()
    got = feed(tdet.Detector(cfg, method=method, device="cpu"), audio)
    close(got, want, rtol=1e-5, atol=1e-6)
    spec, params = tdet.detector_spec_from_config(cfg, "cpu")
    offline = tdet.offline_outputs(spec, params, torch.from_numpy(audio)).numpy()
    close(got, offline, rtol=1e-3, atol=2e-4)


def test_matmul_and_fused_agree(cfg, audio):
    a = feed(tdet.Detector(cfg, method="matmul", device="cpu"), audio)
    b = feed(tdet.Detector(cfg, method="fused", device="cpu"), audio)
    close(b, a, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_matches_jax_detector(cfg, audio, method):
    sizes = [20000, 7000, 13]
    got = feed(tdet.Detector(cfg, method=method, device="cpu"), audio, sizes)
    want = feed(jdet.Detector(cfg, method=method), audio, sizes)
    tol = (1e-4, 1e-5) if method == "matmul" else (1e-3, 2e-4)
    close(got, want, *tol)


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_jax_state_continues_in_port(cfg, audio, method):
    half = len(audio) // 2
    jax_det = jdet.Detector(cfg, method=method)
    feed(jax_det, audio[:half], [5000])
    state = jax_det.get_state()

    port = tdet.Detector(cfg, method=method, device="cpu")
    port.set_state(state)
    got = feed(port, audio[half:], [5000])
    want_jax = feed(jax_det, audio[half:], [5000])

    uninterrupted = tdet.Detector(cfg, method=method, device="cpu")
    feed(uninterrupted, audio[:half], [5000])
    want_port = feed(uninterrupted, audio[half:], [5000])
    close(got, want_port, rtol=1e-5, atol=1e-6)
    tol = (1e-4, 1e-5) if method == "matmul" else (1e-3, 2e-4)
    close(got, want_jax, *tol)
    assert port._frames_seen == jax_det._frames_seen
    np.testing.assert_array_equal(port._residual, jax_det._residual)


def test_port_state_loads_into_jax(cfg, audio):
    port = tdet.Detector(cfg, device="cpu")
    feed(port, audio[:10000])
    jax_det = jdet.Detector(cfg)
    jax_det.set_state(port.get_state())
    x = audio[10000:]
    close(feed(jax_det, x), feed(port, x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_state_files_load_across_packages(cfg, audio, tmp_path, saver):
    """A state file written by one package's ``save_state`` loads into the
    other's ``load_state`` and into its own; continuing the stream gives the
    uninterrupted outputs (rtol=1e-4, atol=1e-5 across the packages, the
    CLI's contract; 1e-5 / 1e-6 within one)."""
    cut = len(audio) // 3 + 41  # mid-hop, mid-frame
    make = {"port": lambda: tdet.Detector(cfg, device="cpu"), "jax": lambda: jdet.Detector(cfg)}
    first = make[saver]()
    feed(first, audio[:cut], [5000])
    path = tmp_path / "state.npz"
    first.save_state(path)
    rest = audio[cut:]
    uninterrupted = make[saver]()
    feed(uninterrupted, audio[:cut], [5000])
    want = feed(uninterrupted, rest, [5000])
    for loader, tol in ((saver, (1e-5, 1e-6)), ({"port": "jax", "jax": "port"}[saver], (1e-4, 1e-5))):
        det = make[loader]()
        det.load_state(path)
        assert det._frames_seen == first._frames_seen
        np.testing.assert_array_equal(det._residual, first._residual)
        close(feed(det, rest, [5000]), want, *tol)


def test_set_state_rejects_foreign_shapes(cfg):
    det = tdet.Detector(cfg, device="cpu")
    state = det.get_state()
    with pytest.raises(ValueError, match="history shape"):
        det.set_state({**state, "history": np.zeros((3, 3), np.float32)})
    # a pending partial interleaved frame is carried, not refused
    det.set_state(
        {**state, "interleave_rem": np.ones(1, np.float32), "interleave_channels": 2}
    )
    after = det.get_state()
    np.testing.assert_array_equal(after["interleave_rem"], np.ones(1, np.float32))
    assert after["interleave_channels"] == 2


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_note_gap_rewarms_like_a_fresh_stream(cfg, audio, method):
    det = tdet.Detector(cfg, method=method, device="cpu")
    feed(det, audio[:9000])
    det.append_audio_data(audio[9000:9500])  # buffered pre-gap audio is dropped
    det.note_gap(123)
    got = feed(det, audio[12000:])
    want = feed(tdet.Detector(cfg, method=method, device="cpu"), audio[12000:])
    close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_backlog_drains_in_bounded_steps(cfg, audio, method, monkeypatch):
    det = tdet.Detector(cfg, method=method, device="cpu")
    det.append_audio_data(audio)
    want = det.drain()
    monkeypatch.setattr(tdet, "MAX_DRAIN_FRAMES", 16)
    det = tdet.Detector(cfg, method=method, device="cpu")
    det.append_audio_data(audio)
    close(det.drain(), want, rtol=1e-5, atol=1e-6)


def test_seen_syllable_and_last_detected_match_jax(audio):
    base = fixtures.sample_geometry_config(5)
    cfg = fixtures.pick_thresholds(base, audio)
    port = tdet.Detector(cfg, device="cpu")
    jax_det = jdet.Detector(cfg)
    pos = 0
    for size in [3000, 6000, 6000, 9000, 2500]:
        for d in (port, jax_det):
            d.append_audio_data(audio[pos : pos + size])
        pos += size
        assert port.seen_syllable() == jax_det.seen_syllable()
        assert port.last_detected == jax_det.last_detected
        np.testing.assert_allclose(
            port.last_outputs, jax_det.last_outputs, rtol=1e-4, atol=1e-5
        )


def test_unfusable_spec_routes_to_matmul(cfg):
    bad = dataclasses.replace(cfg, process_inputs=[ProcessingSpec("normalize")])
    assert tdet.Detector(bad, method="fused", device="cpu").method == "matmul"
    assert tdet.Detector(cfg, method="fused", device="cpu").method == "fused"
    with pytest.raises(ValueError, match="unknown method"):
        tdet.Detector(cfg, method="fft", device="cpu")


def test_deinterleave_frames_matches_jax():
    rng = np.random.default_rng(9)
    rem = np.zeros(0, np.float32)
    jrem = rem
    for n in (7, 12, 1, 0, 30):
        x = rng.standard_normal(n).astype(np.float32)
        frames, rem = tdet.deinterleave_frames(x, rem, 3)
        jframes, jrem = jdet.deinterleave_frames(x, jrem, 3)
        np.testing.assert_array_equal(frames, jframes)
        np.testing.assert_array_equal(rem, jrem)


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_append_interleaved_matches_jax(cfg, audio, method):
    """Interleaved chunks with partial trailing frames, a change of the
    channel count (the carry is dropped) and a gap, against the JAX
    Detector; the carry survives a state handover both ways."""
    stereo = np.stack([audio, audio[::-1].copy()], axis=1).reshape(-1)
    port = tdet.Detector(cfg, method=method, device="cpu")
    ref = jdet.Detector(cfg, method=method)
    tol = (1e-4, 1e-5) if method == "matmul" else (1e-3, 2e-4)
    pos = 0
    for step, size in enumerate([5001, 4000, 8, 9998, 3, 6000, 12001]):
        chunk = stereo[pos : pos + size]
        pos += size
        channels = 3 if step == 4 else 2
        for det in (port, ref):
            det.append_interleaved_data(chunk, channels=channels, channel=1)
        if step == 2:
            ref_state = ref.get_state()
            port = tdet.Detector(cfg, method=method, device="cpu")
            port.set_state(ref_state)
            assert len(ref_state["interleave_rem"]) == 1
        if step == 5:
            for det in (port, ref):
                det.note_gap(10)
        close(port.drain(), np.asarray(ref.drain()), *tol)
        ps, rs = port.get_state(), ref.get_state()
        np.testing.assert_array_equal(ps["interleave_rem"], rs["interleave_rem"])
        assert ps["interleave_channels"] == rs["interleave_channels"]
        np.testing.assert_array_equal(ps["residual"], rs["residual"])
    with pytest.raises(ValueError, match="out of range"):
        port.append_interleaved_data(stereo[:4], channels=2, channel=2)
    jax_det = jdet.Detector(cfg, method=method)
    jax_det.set_state(port.get_state())
    assert jax_det._interleave_channels == port._interleave_channels


@pytest.mark.parametrize("method", ["matmul", "rfft", "fused"])
def test_warm_up_runs_every_bucket(cfg, audio, method):
    det = tdet.Detector(cfg, method=method, device="cpu")
    assert det.warm_up() == len(tdet._FRAME_BUCKETS) == len(jdet._FRAME_BUCKETS)
    assert tdet._FRAME_BUCKETS == jdet._FRAME_BUCKETS
    assert det.warm_up(buckets=(8, 32)) == 2
    # warming leaves the stream untouched
    det.append_audio_data(audio)
    fresh = tdet.Detector(cfg, method=method, device="cpu")
    fresh.append_audio_data(audio)
    close(det.drain(), fresh.drain(), rtol=0, atol=0)
