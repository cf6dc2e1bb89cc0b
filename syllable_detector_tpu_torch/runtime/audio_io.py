"""Audio device abstraction: enumeration, input capture, TTL output.

The reference's AudioInterface drives CoreAudio HAL units (reference:
SyllableDetector/AudioInterface.swift:92-613): device enumeration with
name/UID/channels/sample rates (:97-254), hot-plug listeners (:256-329), a
low-latency input unit delivering 32-sample float32 non-interleaved buffers
per channel to a delegate (:42-73, 474, 567-569), and an output unit whose
render callback synthesizes a TTL waveform — 1.0 for the first
``outputHighFor[ch]`` frames then 0.0 (:13-40), armed by
``createHighOutput(channel, duration)`` (:442-445).

CoreAudio is mac-only; here the same interfaces are defined host-agnostically
with a simulated implementation (deterministic, clockable faster than real
time) used by the live pipeline and tests. A platform backend can register
real devices through the same registry.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

__all__ = [
    "AudioDevice",
    "list_devices",
    "register_device",
    "add_device_change_listener",
    "AudioInputInterface",
    "AudioOutputInterface",
    "SimulatedAudioInput",
    "SimulatedAudioOutput",
]

DEFAULT_FRAME_SIZE = 32  # samples per callback (AudioInterface.swift:474)


@dataclass
class AudioDevice:
    """Device descriptor (AudioInterface.swift:97-232)."""

    device_id: int
    device_uid: str
    device_name: str
    device_manufacturer: str = ""
    streams_input: int = 0
    streams_output: int = 0
    sample_rate_input: float = 44100.0
    sample_rate_output: float = 44100.0
    buffers_input: list[int] = field(default_factory=list)
    buffers_output: list[int] = field(default_factory=list)


_registry: list[AudioDevice] = []
_listeners: list[Callable[[], None]] = []
_registry_lock = threading.Lock()


def register_device(device: AudioDevice) -> None:
    """Add a device to the registry and fire hot-plug listeners
    (AudioInterface.swift:256-329)."""
    with _registry_lock:
        _registry.append(device)
        listeners = list(_listeners)
    for fn in listeners:
        fn()


def list_devices() -> list[AudioDevice]:
    """Enumerate devices (AudioInterface.swift:236-254)."""
    with _registry_lock:
        return list(_registry)


def add_device_change_listener(fn: Callable[[], None]) -> None:
    with _registry_lock:
        _listeners.append(fn)


class AudioInputInterface:
    """Input capture: delivers per-channel float32 buffers to a delegate
    with signature (interface, channel, samples).

    ``gap_delegate`` (interface, lost_frames) is called from the capture
    thread when the DEVICE itself lost audio (an ALSA xrun, a sound-card
    restart): ``lost_frames`` is the estimated per-channel frame count
    that never reached the host. Backends that cannot lose samples
    (simulated sources, PulseAudio's daemon-buffered streams) never call
    it.

    ``block_delegate`` (interface, block[C, n]) is the BULK alternative:
    backends that capture every channel in one read (interleaved
    hardware, the simulator's synchronous tick) deliver the whole
    multi-channel chunk in ONE call when it is set, instead of C
    per-channel ``delegate`` calls — the consumer can then vectorize its
    per-chunk work across channels (Processor.receive_audio_block cuts
    the capture fan-out cost ~3x at high lane counts). When both are
    set, a backend calls ONLY ``block_delegate``; backends that cannot
    produce synchronized blocks ignore it and use ``delegate``."""

    delegate: Optional[Callable[["AudioInputInterface", int, np.ndarray], None]] = None
    block_delegate: Optional[Callable[["AudioInputInterface", np.ndarray], None]] = None
    gap_delegate: Optional[Callable[["AudioInputInterface", int], None]] = None

    def initialize_audio(self) -> None:
        raise NotImplementedError

    def tear_down_audio(self) -> None:
        raise NotImplementedError

    def wait_until_done(self, timeout: float | None = None) -> bool:
        """Block up to ``timeout`` for a FINITE source to finish. Real
        capture hardware never finishes: the default sleeps out the
        timeout and reports False so polling loops keep running. A
        None/0 timeout still sleeps a small minimum — status loops like
        ``monitor --refresh 0`` must not busy-spin against a live device."""
        import time as _t

        _t.sleep(max(timeout or 0.0, 0.01))
        return False


class AudioOutputInterface:
    """TTL output: arm a high pulse of ``duration`` seconds on a channel."""

    def initialize_audio(self) -> None:
        raise NotImplementedError

    def tear_down_audio(self) -> None:
        raise NotImplementedError

    def create_high_output(self, channel: int, duration: float) -> None:
        raise NotImplementedError


class SimulatedAudioInput(AudioInputInterface):
    """Deterministic multi-channel input device.

    ``source(channel, start_sample, n) -> float32[n]`` generates audio;
    buffers of ``frame_size`` samples are delivered per channel, either
    paced to the wall clock (``realtime=True``) or as fast as possible.
    """

    def __init__(
        self,
        source: Callable[[int, int, int], np.ndarray],
        channels: int = 1,
        sample_rate: float = 44100.0,
        frame_size: int = DEFAULT_FRAME_SIZE,
        realtime: bool = False,
        total_samples: Optional[int] = None,
    ):
        self.source = source
        self.channels = channels
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.realtime = realtime
        self.total_samples = total_samples
        self.delegate = None
        self.block_delegate = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples_delivered = 0

    def initialize_audio(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def tear_down_audio(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def wait_until_done(self, timeout: float | None = None) -> bool:
        """Block until total_samples have been delivered (finite sources)."""
        if self._thread is None:
            return True
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def _run(self) -> None:
        pos = 0
        t0 = time.monotonic()
        while not self._stop.is_set():
            if self.total_samples is not None and pos >= self.total_samples:
                break
            n = self.frame_size
            if self.total_samples is not None:
                n = min(n, self.total_samples - pos)
            if self.realtime:
                due = t0 + pos / self.sample_rate
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            block_delegate = self.block_delegate
            if block_delegate is not None:
                # bulk delivery: one [channels, n] block per tick
                block = np.empty((self.channels, n), np.float32)
                for ch in range(self.channels):
                    block[ch] = self.source(ch, pos, n)
                block_delegate(self, block)
            else:
                delegate = self.delegate
                for ch in range(self.channels):
                    chunk = np.asarray(self.source(ch, pos, n), np.float32)
                    if delegate is not None:
                        delegate(self, ch, chunk)
            pos += n
            self.samples_delivered = pos
        self._stop.set()


class SimulatedAudioOutput(AudioOutputInterface):
    """Records TTL events and can render the output waveform.

    Mirrors AudioOutputInterface's render callback semantics: each armed
    pulse writes 1.0 for ``duration * rate`` frames then 0.0
    (AudioInterface.swift:13-40, 442-445).
    """

    def __init__(self, channels: int = 2, sample_rate: float = 44100.0):
        self.channels = channels
        self.sample_rate = sample_rate
        self.events: list[tuple[float, int, float]] = []  # (t, channel, duration)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self.initialized = False

    def initialize_audio(self) -> None:
        self.initialized = True
        self._t0 = time.monotonic()

    def tear_down_audio(self) -> None:
        self.initialized = False

    def create_high_output(self, channel: int, duration: float) -> None:
        with self._lock:
            self.events.append((time.monotonic() - self._t0, channel, duration))

    def render(self, total_seconds: float) -> np.ndarray:
        """Render the TTL waveform [n, channels] from recorded events."""
        n = int(total_seconds * self.sample_rate)
        out = np.zeros((n, self.channels), np.float32)
        with self._lock:
            for t, ch, duration in self.events:
                lo = int(t * self.sample_rate)
                hi = min(n, lo + int(duration * self.sample_rate))
                if lo < n:
                    out[lo:hi, ch] = 1.0
        return out
