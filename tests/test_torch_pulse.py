"""The port's PulseAudio backend (``runtime/pulse.py``) driven by the JAX
tests' fake libpulse-simple and fake async introspection API: graceful
degradation, registration, capture, TTL playback, write errors, open
failures, per-card enumeration and the monitor's ``--list-devices``. No
daemon is needed."""

import contextlib
import ctypes
import io
import threading
import time

import numpy as np
import pytest

from syllable_detector_tpu_torch import monitor
from syllable_detector_tpu_torch.runtime import pulse
from syllable_detector_tpu_torch.runtime.audio_io import list_devices
from syllable_detector_tpu_torch.runtime.pulse import (
    PulseAudioInput,
    PulseAudioOutput,
    register_pulse_devices,
)
from test_pulse import FakePulse, FakePulseAsync


class PortFakePulseAsync(FakePulseAsync):
    """The JAX tests' fake introspection API, delivering the port module's
    info structures to the port's callback type."""

    def _deliver(self, kind, ctx, cb, ud):
        for name, desc, rate, ch in self._infos[kind]:
            info = pulse.PaDeviceInfoHead(
                name=name, index=0, description=desc,
                sample_spec=pulse.PaSampleSpec(pulse.PA_SAMPLE_FLOAT32LE, rate, ch),
            )
            cb(ctx, ctypes.pointer(info), 0, ud)
        cb(ctx, None, 1, ud)  # end of list
        return 7


def test_unavailable_is_graceful(monkeypatch):
    monkeypatch.setattr(pulse, "_load_pulse", lambda: None)
    assert not pulse.pulse_available()
    assert register_pulse_devices() == []
    with pytest.raises(RuntimeError, match="not available"):
        PulseAudioInput().initialize_audio()
    with pytest.raises(RuntimeError, match="not available"):
        PulseAudioOutput().initialize_audio()


def test_fake_registration(monkeypatch):
    monkeypatch.setenv("PULSE_SOURCE", "mic.usb")
    monkeypatch.setattr(pulse, "_load_pulse_async", lambda: None)
    fake = FakePulse()
    uids = [d.device_uid for d in register_pulse_devices(lib=fake)]
    assert {"pulse:default-source", "pulse:default-sink", "pulse:mic.usb"} <= set(uids)
    assert "pulse:default-sink" in [d.device_uid for d in list_devices()]
    assert register_pulse_devices(lib=fake) == []  # idempotent
    assert [d.device_uid for d in list_devices()].count("pulse:default-sink") == 1


def test_fake_capture_delivers_channels():
    fake = FakePulse(channels=2)
    inp = PulseAudioInput(channels=2, frame_size=16, lib=fake)
    got = {0: [], 1: []}
    done = threading.Event()

    def delegate(interface, ch, samples):
        got[ch].append(samples.copy())
        if len(got[1]) >= 4:
            done.set()

    inp.delegate = delegate
    inp.initialize_audio()
    assert done.wait(timeout=5)
    inp.tear_down_audio()
    np.testing.assert_array_equal(np.concatenate(got[0][:4]), np.arange(0, 128, 2, dtype=np.float32))
    np.testing.assert_array_equal(np.concatenate(got[1][:4]), np.arange(1, 128, 2, dtype=np.float32))
    assert fake.freed == 1
    assert fake.specs[0][0] == pulse.PA_STREAM_RECORD


def test_fake_output_ttl_pulse():
    fake = FakePulse(channels=2)
    out = PulseAudioOutput(channels=2, frame_size=16, sample_rate=16000, lib=fake)
    out.initialize_audio()
    out.create_high_output(1, duration=0.002)  # 32 frames = 2 buffers
    deadline = time.monotonic() + 5
    while len(fake.written) < 8 and time.monotonic() < deadline:
        time.sleep(0.005)
    out.tear_down_audio()
    wave = np.concatenate(fake.written, axis=0)
    assert np.all((wave == 0.0) | (wave == 1.0))
    assert wave[:, 0].sum() == 0
    assert int(wave[:, 1].sum()) == 32
    idx = np.flatnonzero(wave[:, 1])
    assert len(idx) and idx[-1] - idx[0] + 1 == len(idx)
    assert fake.specs[0][0] == pulse.PA_STREAM_PLAYBACK


def test_write_error_restores_ttl_frames():
    fake = FakePulse(channels=1, fail_after=0)
    out = PulseAudioOutput(channels=1, frame_size=16, sample_rate=16000, lib=fake)
    out.initialize_audio()
    out.create_high_output(0, duration=0.002)  # 32 frames
    deadline = time.monotonic() + 5
    while out.underruns < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    try:
        assert out.underruns >= 3
        with out._lock:
            assert out._high_for[0] == 32  # nothing consumed while erroring
    finally:
        out.tear_down_audio()


def test_open_failure_raises():
    with pytest.raises(RuntimeError, match="pa_simple_new"):
        PulseAudioInput(lib=FakePulse(fail_open=True)).initialize_audio()


def test_enumerate_pulse_devices_fake():
    fake = PortFakePulseAsync()
    infos = pulse.enumerate_pulse_devices(lib=fake)
    assert len(infos) == 3
    sources = [i for i in infos if i["kind"] == "source"]
    assert [s["name"] for s in sources] == ["alsa_input.card0", "alsa_input.usb1"]
    assert sources[0]["description"] == "Built-in Microphone"
    assert sources[1]["rate"] == 48000 and sources[1]["channels"] == 1
    assert [i["name"] for i in infos if i["kind"] == "sink"] == ["alsa_output.card0"]
    assert fake.freed
    failing = PortFakePulseAsync(fail_connect=True)
    assert pulse.enumerate_pulse_devices(lib=failing) == [] and failing.freed


def test_register_enumerated_devices(monkeypatch):
    monkeypatch.setattr(pulse, "_registered_uids", set())
    devices = register_pulse_devices(lib=object(), introspect_lib=PortFakePulseAsync())
    uids = {d.device_uid for d in devices}
    assert {"pulse:alsa_input.card0", "pulse:alsa_input.usb1", "pulse:alsa_output.card0",
            "pulse:default-source"} <= uids
    usb = next(d for d in devices if d.device_uid == "pulse:alsa_input.usb1")
    assert usb.streams_input == 1 and usb.streams_output == 0
    assert usb.sample_rate_input == 48000.0
    card0 = next(d for d in devices if d.device_uid == "pulse:alsa_output.card0")
    assert card0.streams_output == 2 and card0.streams_input == 0


def test_monitor_list_devices_shows_enumerated(monkeypatch):
    monkeypatch.setattr(pulse, "_registered_uids", set())
    monkeypatch.setattr(pulse, "_load_pulse", lambda: object())
    monkeypatch.setattr(pulse, "_load_pulse_async", lambda: PortFakePulseAsync())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert monitor.main(["--list-devices"]) == 0
    assert "pulse:alsa_input.usb1" in out.getvalue()
    assert "USB Audio CODEC" in out.getvalue()


def test_teardown_plays_out_an_armed_pulse():
    """A pulse armed while the render loop is inside a write, with the
    tear-down already begun, still reaches the wire before the loop stops."""
    from syllable_detector_tpu_torch.fixtures import ReplayPulse

    entered, release = threading.Event(), threading.Event()

    class HeldPulse(ReplayPulse):
        def pa_simple_write(self, h, ptr, nbytes, err_ref):
            if not entered.is_set():
                entered.set()
                release.wait(timeout=10)
            return super().pa_simple_write(h, ptr, nbytes, err_ref)

    fake = HeldPulse(np.zeros(16, np.float32), channels=2, rate=16000)
    out = PulseAudioOutput(channels=2, frame_size=16, sample_rate=16000, lib=fake)
    out.initialize_audio()
    assert entered.wait(timeout=5)
    out.create_high_output(1, duration=0.001)  # 16 frames, after the held buffer
    closing = threading.Thread(target=out.tear_down_audio)
    closing.start()
    deadline = time.monotonic() + 5
    while not out._stop.is_set() and time.monotonic() < deadline:
        time.sleep(0.001)
    release.set()
    closing.join(timeout=10)
    assert not closing.is_alive()
    assert fake.pulses.tolist() == [0, 1]
