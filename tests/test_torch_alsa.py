"""The port's ALSA backend (``runtime/alsa.py``) against the JAX package's:
the pure helpers equal the JAX functions, and the JAX tests' fake-libasound
cases (enumeration, capture per channel and as blocks, the xrun gap
estimate, TTL playback, short writes, open failures, a stuck reader, no
library) drive the port's module. No sound card is needed."""

import threading
import time

import numpy as np
import pytest

from syllable_detector_tpu.runtime import alsa as jalsa
from syllable_detector_tpu_torch.runtime import alsa
from syllable_detector_tpu_torch.runtime.alsa import (
    AlsaAudioInput,
    AlsaAudioOutput,
    deinterleave,
    register_alsa_devices,
    ttl_fill,
)
from syllable_detector_tpu_torch.runtime.audio_io import list_devices
from test_alsa import FakeAlsa


@pytest.mark.parametrize("channels", [1, 2, 3, 8])
def test_deinterleave_matches_jax(channels):
    buf = np.random.default_rng(channels).standard_normal(64 * channels + 5).astype(np.float32)
    got, want = deinterleave(buf, channels), jalsa.deinterleave(buf, channels)
    assert len(got) == len(want) == channels
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.flags.c_contiguous


@pytest.mark.parametrize("frames", [1, 16, 64])
def test_ttl_fill_matches_jax(frames):
    rng = np.random.default_rng(frames)
    high = rng.integers(0, 3 * frames, 6)
    got_high, want_high = high.copy(), high.copy()
    for _ in range(4):
        got = np.full((frames, 6), -1.0, np.float32)
        want = got.copy()
        ttl_fill(got, got_high)
        jalsa.ttl_fill(want, want_high)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_high, want_high)
    assert not got_high.any()


def test_unavailable_is_graceful(monkeypatch):
    monkeypatch.setattr(alsa, "_load_alsa", lambda: None)
    assert not alsa.alsa_available()
    assert register_alsa_devices() == []
    with pytest.raises(RuntimeError, match="not available"):
        AlsaAudioInput().initialize_audio()
    with pytest.raises(RuntimeError, match="not available"):
        AlsaAudioOutput().initialize_audio()


def test_fake_enumeration():
    fake = FakeAlsa()
    devices = register_alsa_devices(lib=fake)
    assert len(devices) == 2
    assert devices[0].device_uid == "alsa:hw:CARD=Fake,DEV=0"
    assert devices[0].device_name == "Fake Soundcard"
    assert devices[0].streams_input == 1 and devices[0].streams_output == 1
    assert devices[1].streams_input == 0  # IOID=Output
    assert devices[0].device_id != devices[1].device_id
    assert "alsa:hw:CARD=Fake,DEV=0" in [d.device_uid for d in list_devices()]
    # idempotent: re-enumeration registers nothing new
    assert register_alsa_devices(lib=fake) == []
    assert [d.device_uid for d in list_devices()].count("alsa:hw:CARD=Fake,DEV=0") == 1


def _capture(inp, blocks: bool):
    """Run ``inp`` until 4 reads arrived; (per-channel chunks, blocks)."""
    got = {0: [], 1: []}
    block_list = []
    done = threading.Event()

    def delegate(interface, ch, samples):
        got[ch].append(samples.copy())
        if len(got[1]) >= 4:
            done.set()

    def block_delegate(interface, block):
        block_list.append(block.copy())
        if len(block_list) >= 4:
            done.set()

    inp.delegate = delegate
    if blocks:
        inp.block_delegate = block_delegate
    inp.initialize_audio()
    try:
        assert done.wait(timeout=5)
    finally:
        inp.tear_down_audio()
    return got, block_list


@pytest.mark.parametrize("blocks", [False, True], ids=["per-channel", "blocks"])
def test_fake_capture_delivers_channels(blocks):
    fake = FakeAlsa(channels=2)
    got, block_list = _capture(AlsaAudioInput(channels=2, frame_size=16, lib=fake), blocks)
    if blocks:
        assert not got[0] and not got[1]  # only the block delegate is called
        glued = np.concatenate(block_list[:4], axis=1)
        c0, c1 = glued
    else:
        c0, c1 = np.concatenate(got[0][:4]), np.concatenate(got[1][:4])
    # the counter ramp de-interleaved: even values on channel 0, odd on 1
    np.testing.assert_array_equal(c0, np.arange(0, 128, 2, dtype=np.float32))
    np.testing.assert_array_equal(c1, np.arange(1, 128, 2, dtype=np.float32))
    assert fake.closed == 1


def test_fake_capture_xrun_reports_gap():
    """An xrun discards device-buffered audio; the input estimates the hole
    by wall-clock drift and reports it through gap_delegate."""
    rate, frame = 16000.0, 16
    clock = {"now": 0.0}

    class XrunAlsa(FakeAlsa):
        def __init__(self):
            super().__init__(channels=1)
            self.reads = 0

        def snd_pcm_readi(self, h, ptr, frames):
            self.reads += 1
            if self.reads == 5:
                clock["now"] += 1000 / rate  # the device lost 1000 frames
                return -32  # -EPIPE: overrun
            clock["now"] += int(frames) / rate
            return super().snd_pcm_readi(h, ptr, frames)

    fake = XrunAlsa()
    inp = AlsaAudioInput(channels=1, frame_size=frame, sample_rate=rate, lib=fake,
                         clock=lambda: clock["now"])
    gaps = []
    done = threading.Event()
    inp.gap_delegate = lambda interface, lost: gaps.append(lost)
    inp.delegate = lambda interface, ch, samples: done.set() if fake.reads >= 8 else None
    inp.initialize_audio()
    assert done.wait(timeout=5)
    inp.tear_down_audio()
    assert inp.overruns == 1
    # the true hole less the first chunk, captured before the anchor stamp
    assert gaps == [1000 - frame]
    assert inp.lost_frames == 1000 - frame


def _played(fake, out, enough) -> np.ndarray:
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not enough():
        time.sleep(0.005)
    out.tear_down_audio()
    return np.concatenate(fake.written, axis=0)


def test_fake_output_ttl_pulse():
    fake = FakeAlsa(channels=2)
    out = AlsaAudioOutput(channels=2, frame_size=16, sample_rate=16000, lib=fake)
    out.initialize_audio()
    out.create_high_output(1, duration=0.002)  # 32 frames = 2 buffers
    wave = _played(fake, out, lambda: len(fake.written) >= 8)
    assert np.all((wave == 0.0) | (wave == 1.0))
    assert wave[:, 0].sum() == 0
    assert int(wave[:, 1].sum()) == 32  # duration * rate frames high
    idx = np.flatnonzero(wave[:, 1])
    assert len(idx) and idx[-1] - idx[0] + 1 == len(idx)  # one contiguous run


def test_short_write_restores_ttl_frames():
    class ShortWriteAlsa(FakeAlsa):
        def snd_pcm_writei(self, h, ptr, frames):
            super().snd_pcm_writei(h, ptr, frames)
            self.written[-1] = self.written[-1][:4]  # only 4 frames played
            return 4

    fake = ShortWriteAlsa(channels=1)
    out = AlsaAudioOutput(channels=1, frame_size=16, sample_rate=16000, lib=fake)
    out.initialize_audio()
    out.create_high_output(0, duration=0.002)  # 32 frames

    def enough():
        # the played frames, not the armed count: a write in flight has
        # deducted frames it gives back only after it returns
        return sum(float(w.sum()) for w in list(fake.written)) >= 32 and len(fake.written) >= 10

    wave = _played(fake, out, enough)[:, 0]
    assert int(wave.sum()) == 32  # the full pulse reached the device


def test_open_failure_raises():
    with pytest.raises(RuntimeError, match="snd_pcm_open"):
        AlsaAudioInput(lib=FakeAlsa(fail_open=True)).initialize_audio()


def test_teardown_with_stuck_reader_leaks_not_crashes():
    """A reader stuck in a blocking device call keeps its PCM: tear_down
    returns after its join times out and frees nothing under the thread."""
    release = threading.Event()

    class BlockingAlsa(FakeAlsa):
        def snd_pcm_readi(self, h, ptr, frames):
            release.wait(timeout=30)
            return -32

    fake = BlockingAlsa(channels=1)
    inp = AlsaAudioInput(channels=1, frame_size=16, lib=fake)
    inp.initialize_audio()
    time.sleep(0.05)
    t0 = time.monotonic()
    try:
        inp.tear_down_audio()
        assert 4.0 < time.monotonic() - t0 < 10.0
        assert inp._pcm is not None and fake.closed == 0
    finally:
        release.set()
