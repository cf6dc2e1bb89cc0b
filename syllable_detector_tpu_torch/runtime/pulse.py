"""Real audio device backend: PulseAudio via ctypes (Linux desktops).

Second Linux backend next to ALSA (``runtime/alsa.py``), for systems where
the sound card is owned by a PulseAudio/PipeWire daemon and direct ALSA
``hw:`` access would fail. Same role as the reference's CoreAudio HAL units
(reference: SyllableDetector/AudioInterface.swift:462-580 input, :13-40
output), implemented over libpulse's *simple* synchronous API:

  * :func:`register_pulse_devices` adds the daemon's default source/sink
    (plus ``PULSE_SOURCE``/``PULSE_SINK`` overrides) to the shared device
    registry so ``monitor --list-devices`` shows them. The simple API has
    no enumeration call — per-card listing is the daemon's job; the ALSA
    backend already enumerates the underlying PCMs.
  * :class:`PulseAudioInput` opens a RECORD stream and reads small
    interleaved float32 fragments on a thread, de-interleaves, and calls
    the standard ``delegate(interface, channel, samples)`` — the same
    contract SimulatedAudioInput and AlsaAudioInput implement.
  * :class:`PulseAudioOutput` runs a PLAYBACK render loop synthesizing the
    TTL waveform exactly like the reference's renderOutput
    (AudioInterface.swift:13-40); ``create_high_output(channel, duration)``
    arms it (:442-445).

Degrades gracefully: with no libpulse-simple (or no daemon) the module
loads, :func:`pulse_available` returns False, and opens raise RuntimeError.
The library handle is injectable for tests.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from syllable_detector_tpu_torch.runtime.alsa import deinterleave, ttl_fill
from syllable_detector_tpu_torch.runtime.audio_io import (
    AudioDevice,
    AudioInputInterface,
    AudioOutputInterface,
    register_device,
)

__all__ = [
    "pulse_available",
    "register_pulse_devices",
    "enumerate_pulse_devices",
    "PulseAudioInput",
    "PulseAudioOutput",
]

# pulse/def.h
PA_STREAM_PLAYBACK = 1
PA_STREAM_RECORD = 2
# pulse/sample.h
PA_SAMPLE_FLOAT32LE = 5


class PaSampleSpec(ctypes.Structure):
    _fields_ = [
        ("format", ctypes.c_int),
        ("rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint8),
    ]


class PaBufferAttr(ctypes.Structure):
    # (uint32_t)-1 selects the daemon default for any field
    _fields_ = [
        ("maxlength", ctypes.c_uint32),
        ("tlength", ctypes.c_uint32),
        ("prebuf", ctypes.c_uint32),
        ("minreq", ctypes.c_uint32),
        ("fragsize", ctypes.c_uint32),
    ]


_pulse = None
_pulse_tried = False


def _load_pulse():
    """dlopen libpulse-simple once; None when absent."""
    global _pulse, _pulse_tried
    if _pulse_tried:
        return _pulse
    _pulse_tried = True
    try:
        lib = ctypes.CDLL("libpulse-simple.so.0")
    except OSError:
        _pulse = None
        return None
    lib.pa_simple_new.argtypes = [
        ctypes.c_char_p,  # server (NULL = default)
        ctypes.c_char_p,  # client name
        ctypes.c_int,  # direction
        ctypes.c_char_p,  # device (NULL = default source/sink)
        ctypes.c_char_p,  # stream name
        ctypes.POINTER(PaSampleSpec),
        ctypes.c_void_p,  # channel map (NULL = default)
        ctypes.POINTER(PaBufferAttr),
        ctypes.POINTER(ctypes.c_int),  # error out
    ]
    lib.pa_simple_new.restype = ctypes.c_void_p
    lib.pa_simple_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pa_simple_read.restype = ctypes.c_int
    lib.pa_simple_write.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pa_simple_write.restype = ctypes.c_int
    lib.pa_simple_free.argtypes = [ctypes.c_void_p]
    lib.pa_simple_free.restype = None
    try:
        lib.pa_strerror.argtypes = [ctypes.c_int]
        lib.pa_strerror.restype = ctypes.c_char_p
    except AttributeError:  # pragma: no cover - always linked in practice
        pass
    _pulse = lib
    return lib


def pulse_available() -> bool:
    return _load_pulse() is not None


def _strerror(lib, err: int) -> str:
    fn = getattr(lib, "pa_strerror", None)
    if fn is None:
        return f"error {err}"
    try:
        msg = fn(int(err))
    except Exception:
        return f"error {err}"
    if isinstance(msg, bytes):
        return msg.decode(errors="replace")
    return str(msg) if msg else f"error {err}"


# ---------------------------------------------------------------------------
# per-card enumeration via the ASYNC mainloop API (libpulse.so.0)
# ---------------------------------------------------------------------------
# The simple API (above) has no introspection calls; the reference
# enumerates every device with UID/name/streams
# (AudioInterface.swift:97-232). This is the libpulse equivalent: a
# throwaway pa_mainloop + pa_context, iterated synchronously until the
# source/sink info lists drain.

# pulse/context.h states; pulse/operation.h states
PA_CONTEXT_READY = 4
PA_CONTEXT_FAILED = 5
PA_CONTEXT_TERMINATED = 6
PA_OPERATION_RUNNING = 0


class PaDeviceInfoHead(ctypes.Structure):
    """Leading fields shared by pa_source_info and pa_sink_info
    (pulse/introspect.h) — the callbacks only read these."""

    _fields_ = [
        ("name", ctypes.c_char_p),
        ("index", ctypes.c_uint32),
        ("description", ctypes.c_char_p),
        ("sample_spec", PaSampleSpec),
    ]


_INFO_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.POINTER(PaDeviceInfoHead), ctypes.c_int,
    ctypes.c_void_p,
)

_pulse_async = None
_pulse_async_tried = False


def _load_pulse_async():
    """dlopen libpulse (the full async API) once; None when absent."""
    global _pulse_async, _pulse_async_tried
    if _pulse_async_tried:
        return _pulse_async
    _pulse_async_tried = True
    try:
        lib = ctypes.CDLL("libpulse.so.0")
    except OSError:
        _pulse_async = None
        return None
    lib.pa_mainloop_new.restype = ctypes.c_void_p
    lib.pa_mainloop_get_api.restype = ctypes.c_void_p
    lib.pa_mainloop_get_api.argtypes = [ctypes.c_void_p]
    lib.pa_context_new.restype = ctypes.c_void_p
    lib.pa_context_new.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pa_context_connect.restype = ctypes.c_int
    lib.pa_context_connect.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pa_context_get_state.restype = ctypes.c_int
    lib.pa_context_get_state.argtypes = [ctypes.c_void_p]
    lib.pa_mainloop_iterate.restype = ctypes.c_int
    lib.pa_mainloop_iterate.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    for fn in ("pa_context_get_source_info_list", "pa_context_get_sink_info_list"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_void_p
        f.argtypes = [ctypes.c_void_p, _INFO_CB, ctypes.c_void_p]
    lib.pa_operation_get_state.restype = ctypes.c_int
    lib.pa_operation_get_state.argtypes = [ctypes.c_void_p]
    lib.pa_operation_unref.argtypes = [ctypes.c_void_p]
    lib.pa_context_disconnect.argtypes = [ctypes.c_void_p]
    lib.pa_context_unref.argtypes = [ctypes.c_void_p]
    lib.pa_mainloop_free.argtypes = [ctypes.c_void_p]
    _pulse_async = lib
    return lib


def enumerate_pulse_devices(lib=None, timeout: float = 2.0) -> list[dict]:
    """Enumerate every PulseAudio source and sink via the async
    introspection API -> [{kind, name, description, rate, channels}, ...].

    Spins a private pa_mainloop until the context is READY, drains the
    source and sink info lists, and tears everything down. Returns [] when
    libpulse or the daemon is unavailable (no daemon in CI containers).
    """
    import time as _t

    lib = lib if lib is not None else _load_pulse_async()
    if lib is None:
        return []
    results: list[dict] = []
    m = lib.pa_mainloop_new()
    if not m:
        return []
    ctx = None
    try:
        api = lib.pa_mainloop_get_api(m)
        ctx = lib.pa_context_new(api, b"syllable_detector_tpu")
        if not ctx:
            return []
        if lib.pa_context_connect(ctx, None, 0, None) < 0:
            return []
        deadline = _t.monotonic() + timeout
        while True:
            state = lib.pa_context_get_state(ctx)
            if state == PA_CONTEXT_READY:
                break
            if state in (PA_CONTEXT_FAILED, PA_CONTEXT_TERMINATED):
                return []
            if _t.monotonic() > deadline:
                return []
            lib.pa_mainloop_iterate(m, 1, None)

        def drain(kind: str, getlist):
            def on_info(_ctx, info, eol, _ud):
                if eol or not info:
                    return
                i = info.contents
                results.append(
                    {
                        "kind": kind,
                        "name": (i.name or b"").decode(errors="replace"),
                        "description": (i.description or b"").decode(
                            errors="replace"
                        ),
                        "rate": int(i.sample_spec.rate),
                        "channels": int(i.sample_spec.channels),
                    }
                )

            cb = _INFO_CB(on_info)  # keep alive until the operation ends
            op = getlist(ctx, cb, None)
            if not op:
                return
            while lib.pa_operation_get_state(op) == PA_OPERATION_RUNNING:
                if _t.monotonic() > deadline:
                    break
                lib.pa_mainloop_iterate(m, 1, None)
            lib.pa_operation_unref(op)

        drain("source", lib.pa_context_get_source_info_list)
        drain("sink", lib.pa_context_get_sink_info_list)
        return results
    finally:
        if ctx:
            lib.pa_context_disconnect(ctx)
            lib.pa_context_unref(ctx)
        lib.pa_mainloop_free(m)


_registered_uids: set = set()
_next_device_id = [2000]  # distinct id block from the ALSA enumerator


def register_pulse_devices(lib=None, introspect_lib=None) -> list[AudioDevice]:
    """Register PulseAudio devices into the shared registry — the CoreAudio
    devices() counterpart (AudioInterface.swift:236-254) for daemon-routed
    audio.

    Every per-card source/sink the async introspection API reports
    (:func:`enumerate_pulse_devices`) is registered with its daemon name as
    UID; the daemon's default source/sink (plus ``PULSE_SOURCE``/
    ``PULSE_SINK`` env overrides) are always present as fallbacks — the
    simple-API streams open by those names either way.

    Idempotent; returns newly registered devices, empty when libpulse is
    unavailable.
    """
    lib = lib if lib is not None else _load_pulse()
    if lib is None:
        return []
    entries = []
    for info in enumerate_pulse_devices(lib=introspect_lib):
        n_in = info["channels"] if info["kind"] == "source" else 0
        n_out = info["channels"] if info["kind"] == "sink" else 0
        entries.append(
            (
                f"pulse:{info['name']}",
                info["description"] or f"PulseAudio {info['kind']} {info['name']}",
                n_in,
                n_out,
                float(info["rate"]) or 44100.0,
            )
        )
    entries += [
        ("pulse:default-source", "PulseAudio default source", 1, 0, 44100.0),
        ("pulse:default-sink", "PulseAudio default sink", 0, 1, 44100.0),
    ]
    src = os.environ.get("PULSE_SOURCE")
    if src:
        entries.append((f"pulse:{src}", f"PulseAudio source {src}", 1, 0, 44100.0))
    sink = os.environ.get("PULSE_SINK")
    if sink:
        entries.append((f"pulse:{sink}", f"PulseAudio sink {sink}", 0, 1, 44100.0))
    devices = []
    for uid, name, n_in, n_out, rate in entries:
        if uid in _registered_uids:
            continue
        dev = AudioDevice(
            device_id=_next_device_id[0],
            device_uid=uid,
            device_name=name,
            device_manufacturer="PulseAudio",
            streams_input=n_in,
            streams_output=n_out,
            sample_rate_input=rate,
            sample_rate_output=rate,
        )
        _next_device_id[0] += 1
        _registered_uids.add(uid)
        register_device(dev)
        devices.append(dev)
    return devices


class _PulseStream:
    """RAII wrapper over one pa_simple stream."""

    def __init__(self, lib, direction: int, device: Optional[str],
                 channels: int, rate: float, frame_size: int,
                 client: str, stream: str):
        self.lib = lib
        spec = PaSampleSpec(PA_SAMPLE_FLOAT32LE, int(rate), channels)
        none = ctypes.c_uint32(-1).value
        frag = frame_size * channels * 4
        if direction == PA_STREAM_RECORD:
            attr = PaBufferAttr(none, none, none, none, frag)
        else:
            # keep the daemon-side queue short so armed TTL pulses reach
            # the wire quickly (the reference's 32-sample HAL buffers play
            # the same role, AudioInterface.swift:474)
            attr = PaBufferAttr(none, 2 * frag, none, none, none)
        err = ctypes.c_int(0)
        self.handle = lib.pa_simple_new(
            None, client.encode(), direction,
            device.encode() if device else None, stream.encode(),
            ctypes.byref(spec), None, ctypes.byref(attr), ctypes.byref(err),
        )
        if not self.handle:
            raise RuntimeError(
                f"pa_simple_new({device or 'default'!r}) failed: "
                f"{_strerror(lib, err.value)}"
            )

    def close(self):
        if self.handle:
            self.lib.pa_simple_free(self.handle)
            self.handle = None


class PulseAudioInput(AudioInputInterface):
    """RECORD stream -> per-channel delegate callbacks on a reader thread.

    ``frame_size`` is the frames-per-callback granularity (the reference
    uses 32, AudioInterface.swift:474; Pulse fragments usually bottom out
    around 10-25 ms unless the daemon is configured for low latency).
    """

    def __init__(self, device: Optional[str] = None, channels: int = 1,
                 sample_rate: float = 44100.0, frame_size: int = 64,
                 lib=None):
        self.device = device
        self.channels = channels
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.delegate = None
        self._lib = lib
        self._stream: Optional[_PulseStream] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.overruns = 0

    def initialize_audio(self) -> None:
        lib = self._lib if self._lib is not None else _load_pulse()
        if lib is None:
            raise RuntimeError(
                "PulseAudio (libpulse-simple.so.0) is not available"
            )
        self._stream = _PulseStream(
            lib, PA_STREAM_RECORD, self.device, self.channels,
            self.sample_rate, self.frame_size,
            "syllable_detector_tpu", "capture",
        )
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def tear_down_audio(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
            if t.is_alive():
                # the IO thread is stuck in a blocking device call; freeing
                # the handle under it would be a use-after-free — leak the
                # handle instead (the daemon thread dies with the process)
                return
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def _run(self) -> None:
        lib = self._stream.lib
        buf = np.zeros(self.frame_size * self.channels, np.float32)
        ptr = buf.ctypes.data_as(ctypes.c_void_p)
        err = ctypes.c_int(0)
        while not self._stop.is_set():
            rc = lib.pa_simple_read(
                self._stream.handle, ptr, buf.nbytes, ctypes.byref(err)
            )
            if rc < 0:
                # transient daemon hiccup: count and keep reading (the
                # reference counts overflows and continues,
                # Processor.swift:231-235)
                self.overruns += 1
                if self._stop.wait(0.01):
                    break
                continue
            delegate = self.delegate
            if delegate is None:
                continue
            for ch, chunk in enumerate(deinterleave(buf, self.channels)):
                delegate(self, ch, chunk)


class PulseAudioOutput(AudioOutputInterface):
    """PLAYBACK stream running a render loop that synthesizes TTL pulses."""

    def __init__(self, device: Optional[str] = None, channels: int = 2,
                 sample_rate: float = 44100.0, frame_size: int = 64,
                 lib=None):
        self.device = device
        self.channels = channels
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self._lib = lib
        self._stream: Optional[_PulseStream] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._high_for = np.zeros(channels, np.int64)
        self.underruns = 0

    def initialize_audio(self) -> None:
        lib = self._lib if self._lib is not None else _load_pulse()
        if lib is None:
            raise RuntimeError(
                "PulseAudio (libpulse-simple.so.0) is not available"
            )
        self._stream = _PulseStream(
            lib, PA_STREAM_PLAYBACK, self.device, self.channels,
            self.sample_rate, self.frame_size,
            "syllable_detector_tpu", "ttl",
        )
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def tear_down_audio(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
            if t.is_alive():
                # the IO thread is stuck in a blocking device call; freeing
                # the handle under it would be a use-after-free — leak the
                # handle instead (the daemon thread dies with the process)
                return
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def create_high_output(self, channel: int, duration: float) -> None:
        """Arm a TTL pulse (createHighOutput, AudioInterface.swift:442-445)."""
        with self._lock:
            self._high_for[channel] = max(
                self._high_for[channel], int(duration * self.sample_rate)
            )

    def _run(self) -> None:
        lib = self._stream.lib
        out = np.zeros((self.frame_size, self.channels), np.float32)
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        err = ctypes.c_int(0)
        while True:
            with self._lock:
                # on tear-down, play out the pulses already armed first: a
                # detection of the last drain before shutdown still reaches
                # the wire
                if self._stop.is_set() and not self._high_for.any():
                    break
                before = self._high_for.copy()
                ttl_fill(out, self._high_for)
            rc = lib.pa_simple_write(
                self._stream.handle, ptr, out.nbytes, ctypes.byref(err)
            )
            if rc < 0:
                self.underruns += 1
                # the buffer never reached the daemon: restore the TTL
                # frames ttl_fill deducted so the pulse keeps its full
                # requested duration across the error
                with self._lock:
                    np.maximum(self._high_for, before, out=self._high_for)
                if self._stop.wait(0.01):
                    break
