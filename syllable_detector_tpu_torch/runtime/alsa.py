"""Real audio device backend: ALSA via ctypes (Linux).

The reference captures live audio through CoreAudio HAL units at 32 samples
per callback and renders TTL waveforms in the output unit's render callback
(reference: SyllableDetector/AudioInterface.swift:462-580 input, :13-40
output). This is the Linux equivalent over libasound's simple PCM API:

  * :func:`register_alsa_devices` enumerates PCM devices (snd_device_name_hint)
    into the shared device registry, so ``monitor --list-devices`` shows real
    hardware next to the simulated devices.
  * :class:`AlsaAudioInput` opens a capture PCM, reads small interleaved
    float32 buffers on a thread, de-interleaves, and calls the standard
    ``delegate(interface, channel, samples)`` — the same contract
    SimulatedAudioInput implements.
  * :class:`AlsaAudioOutput` runs a playback thread whose buffer loop
    synthesizes the TTL waveform exactly like the reference's renderOutput:
    1.0 for the first ``high_for[ch]`` frames then 0.0, decremented per
    buffer; ``create_high_output(channel, duration)`` arms it
    (AudioInterface.swift:13-40, 442-445).

Everything degrades gracefully: with no libasound (or no sound card) the
module loads, :func:`alsa_available` returns False, and opens raise
RuntimeError. The libasound handle is injectable for tests.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

import numpy as np

from syllable_detector_tpu_torch.runtime.audio_io import (
    AudioDevice,
    AudioInputInterface,
    AudioOutputInterface,
    register_device,
)

__all__ = [
    "alsa_available",
    "register_alsa_devices",
    "AlsaAudioInput",
    "AlsaAudioOutput",
    "deinterleave",
    "ttl_fill",
]

# ALSA constants (alsa/pcm.h)
SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_FORMAT_FLOAT_LE = 14
SND_PCM_ACCESS_RW_INTERLEAVED = 3

_alsa = None
_alsa_tried = False


def _load_alsa():
    """dlopen libasound once; None when absent."""
    global _alsa, _alsa_tried
    if _alsa_tried:
        return _alsa
    _alsa_tried = True
    try:
        lib = ctypes.CDLL("libasound.so.2")
    except OSError:
        _alsa = None
        return None
    # int snd_pcm_open(snd_pcm_t**, const char*, int stream, int mode)
    lib.snd_pcm_open.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.snd_pcm_open.restype = ctypes.c_int
    lib.snd_pcm_set_params.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_int, ctypes.c_uint,
    ]
    lib.snd_pcm_set_params.restype = ctypes.c_int
    lib.snd_pcm_readi.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong,
    ]
    lib.snd_pcm_readi.restype = ctypes.c_long
    lib.snd_pcm_writei.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong,
    ]
    lib.snd_pcm_writei.restype = ctypes.c_long
    lib.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.snd_pcm_recover.restype = ctypes.c_int
    lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
    lib.snd_pcm_close.restype = ctypes.c_int
    lib.snd_device_name_hint.argtypes = [
        ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p)),
    ]
    lib.snd_device_name_hint.restype = ctypes.c_int
    lib.snd_device_name_get_hint.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.snd_device_name_get_hint.restype = ctypes.c_void_p  # char* we must free
    lib.snd_device_name_free_hint.argtypes = [
        ctypes.POINTER(ctypes.c_void_p)
    ]
    lib.snd_device_name_free_hint.restype = ctypes.c_int
    _alsa = lib
    return lib


def alsa_available() -> bool:
    return _load_alsa() is not None


def _hint_str(lib, hint, key: bytes) -> Optional[str]:
    p = lib.snd_device_name_get_hint(hint, key)
    if not p:
        return None
    try:
        return ctypes.cast(p, ctypes.c_char_p).value.decode(errors="replace")
    finally:
        ctypes.CDLL(None).free(ctypes.c_void_p(p))


# UIDs already in the registry (enumeration is idempotent) and a
# monotonically increasing id base so re-enumeration never reuses ids
_registered_uids: set = set()
_next_device_id = [1000]


def register_alsa_devices(lib=None) -> list[AudioDevice]:
    """Enumerate ALSA PCM devices into the shared device registry
    (the CoreAudio devices() equivalent, AudioInterface.swift:236-254).

    Idempotent: PCMs already registered are skipped, so repeated calls
    (hot-plug refresh, repeated --list-devices) don't duplicate entries.
    Returns the list of devices newly registered; empty when ALSA is
    unavailable.
    """
    lib = lib or _load_alsa()
    if lib is None:
        return []
    hints = ctypes.POINTER(ctypes.c_void_p)()
    if lib.snd_device_name_hint(-1, b"pcm", ctypes.byref(hints)) != 0:
        return []
    devices = []
    try:
        i = 0
        while hints[i]:
            name = _hint_str(lib, hints[i], b"NAME")
            desc = _hint_str(lib, hints[i], b"DESC") or ""
            ioid = _hint_str(lib, hints[i], b"IOID")  # None = both
            i += 1
            if not name:
                continue
            uid = f"alsa:{name}"
            if uid in _registered_uids:
                continue
            dev = AudioDevice(
                device_id=_next_device_id[0],
                device_uid=uid,
                device_name=desc.splitlines()[0] if desc else name,
                device_manufacturer="ALSA",
                streams_input=0 if ioid == "Output" else 1,
                streams_output=0 if ioid == "Input" else 1,
            )
            _next_device_id[0] += 1
            _registered_uids.add(uid)
            register_device(dev)
            devices.append(dev)
    finally:
        lib.snd_device_name_free_hint(hints)
    return devices


def deinterleave(buf: np.ndarray, channels: int) -> list[np.ndarray]:
    """Interleaved [n*channels] float32 -> per-channel contiguous arrays
    (the vDSP_vsadd strided de-interleave,
    CircularShortTimeFourierTransform.swift:203-217 / processInput's
    per-channel render, AudioInterface.swift:42-73)."""
    frames = len(buf) // channels
    view = buf[: frames * channels].reshape(frames, channels)
    return [np.ascontiguousarray(view[:, c]) for c in range(channels)]


def ttl_fill(out: np.ndarray, high_for: np.ndarray) -> None:
    """Fill an interleaved [frames, channels] buffer with the TTL waveform:
    1.0 for the first ``high_for[ch]`` frames then 0.0, decrementing
    ``high_for`` in place — renderOutput's exact semantics
    (AudioInterface.swift:13-40)."""
    frames = out.shape[0]
    for ch in range(out.shape[1]):
        h = int(high_for[ch])
        if h > 0:
            k = min(h, frames)
            out[:k, ch] = 1.0
            out[k:, ch] = 0.0
            high_for[ch] = h - k
        else:
            out[:, ch] = 0.0


class _AlsaPcm:
    """Thin RAII wrapper over one PCM handle."""

    def __init__(self, lib, name: str, stream: int, channels: int,
                 rate: float, latency_us: int):
        self.lib = lib
        self.handle = ctypes.c_void_p()
        rc = lib.snd_pcm_open(
            ctypes.byref(self.handle), name.encode(), stream, 0
        )
        if rc != 0:
            raise RuntimeError(f"snd_pcm_open({name!r}) failed: {rc}")
        self._open = True
        rc = lib.snd_pcm_set_params(
            self.handle,
            SND_PCM_FORMAT_FLOAT_LE,
            SND_PCM_ACCESS_RW_INTERLEAVED,
            channels,
            int(rate),
            1,  # allow soft resample
            latency_us,
        )
        if rc != 0:
            self.close()
            raise RuntimeError(f"snd_pcm_set_params({name!r}) failed: {rc}")

    def close(self):
        if getattr(self, "_open", False):
            self._open = False
            self.lib.snd_pcm_close(self.handle)
            self.handle = ctypes.c_void_p()


class AlsaAudioInput(AudioInputInterface):
    """Capture PCM -> per-channel delegate callbacks on a reader thread.

    ``frame_size`` is the frames-per-callback granularity (the reference
    uses 32, AudioInterface.swift:474; ALSA devices usually bottom out
    around 64-128 frames of real latency).
    """

    def __init__(self, device: str = "default", channels: int = 1,
                 sample_rate: float = 44100.0, frame_size: int = 64,
                 latency_us: int = 20000, lib=None, clock=None):
        self.device = device
        self.channels = channels
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.latency_us = latency_us
        self.delegate = None
        self.block_delegate = None
        self.gap_delegate = None
        self._lib = lib
        self._pcm: Optional[_AlsaPcm] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.overruns = 0
        self.lost_frames = 0  # estimated device-side losses across xruns
        # injectable monotonic clock (tests drive the drift estimator)
        self._clock = clock if clock is not None else time.monotonic

    def initialize_audio(self) -> None:
        lib = self._lib or _load_alsa()
        if lib is None:
            raise RuntimeError("ALSA (libasound.so.2) is not available")
        self._pcm = _AlsaPcm(
            lib, self.device, SND_PCM_STREAM_CAPTURE, self.channels,
            self.sample_rate, self.latency_us,
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
        if self._pcm is not None:
            self._pcm.close()
            self._pcm = None

    def _run(self) -> None:
        lib = self._pcm.lib
        buf = np.zeros(self.frame_size * self.channels, np.float32)
        ptr = buf.ctypes.data_as(ctypes.c_void_p)
        # drift accounting for xrun loss estimation: frames the device
        # SHOULD have produced since the first read (wall clock × rate)
        # minus frames actually delivered ≈ frames dropped in xruns
        delivered = 0  # frames read + frames already charged to gaps
        anchor = None  # monotonic stamp at the first successful read
        while not self._stop.is_set():
            got = lib.snd_pcm_readi(self._pcm.handle, ptr, self.frame_size)
            if got < 0:
                # xrun/suspend: recover and continue (the reference counts
                # overflows and keeps going, Processor.swift:231-235) —
                # but the overrun DISCARDED buffered capture data, so
                # estimate the hole and surface it as a gap (downstream
                # sample accounting stays honest; the estimate is wall-
                # clock drift, accurate to ~one device buffer)
                self.overruns += 1
                if anchor is not None:
                    lost = int(
                        round((self._clock() - anchor) * self.sample_rate)
                        - delivered
                    )
                    if lost > 0:
                        delivered += lost  # charged: don't double-count
                        self.lost_frames += lost
                        gap = self.gap_delegate
                        if gap is not None:
                            gap(self, lost)
                if lib.snd_pcm_recover(self._pcm.handle, int(got), 1) < 0:
                    break
                continue
            if got == 0:
                continue
            if anchor is None:
                anchor = self._clock()
            delivered += int(got)
            block_delegate = self.block_delegate
            if block_delegate is not None:
                # interleaved hardware reads every channel in one buffer:
                # deliver it as one [C, got] block (one transpose copy)
                block = np.ascontiguousarray(
                    buf[: int(got) * self.channels]
                    .reshape(int(got), self.channels).T
                )
                block_delegate(self, block)
                continue
            delegate = self.delegate
            if delegate is None:
                continue
            for ch, chunk in enumerate(
                deinterleave(buf[: int(got) * self.channels], self.channels)
            ):
                delegate(self, ch, chunk)


class AlsaAudioOutput(AudioOutputInterface):
    """Playback PCM running a render loop that synthesizes TTL pulses."""

    def __init__(self, device: str = "default", channels: int = 2,
                 sample_rate: float = 44100.0, frame_size: int = 64,
                 latency_us: int = 20000, lib=None):
        self.device = device
        self.channels = channels
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.latency_us = latency_us
        self._lib = lib
        self._pcm: Optional[_AlsaPcm] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._high_for = np.zeros(channels, np.int64)
        self.underruns = 0

    def initialize_audio(self) -> None:
        lib = self._lib or _load_alsa()
        if lib is None:
            raise RuntimeError("ALSA (libasound.so.2) is not available")
        self._pcm = _AlsaPcm(
            lib, self.device, SND_PCM_STREAM_PLAYBACK, self.channels,
            self.sample_rate, self.latency_us,
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
        if self._pcm is not None:
            self._pcm.close()
            self._pcm = None

    def create_high_output(self, channel: int, duration: float) -> None:
        """Arm a TTL pulse (createHighOutput, AudioInterface.swift:442-445)."""
        with self._lock:
            self._high_for[channel] = max(
                self._high_for[channel], int(duration * self.sample_rate)
            )

    def _run(self) -> None:
        lib = self._pcm.lib
        out = np.zeros((self.frame_size, self.channels), np.float32)
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        while True:
            with self._lock:
                # on tear-down, play out the pulses already armed first: a
                # detection of the last drain before shutdown still reaches
                # the wire
                if self._stop.is_set() and not self._high_for.any():
                    break
                before = self._high_for.copy()
                ttl_fill(out, self._high_for)
            wrote = lib.snd_pcm_writei(self._pcm.handle, ptr, self.frame_size)
            if wrote < 0:
                self.underruns += 1
                # the buffer never reached the device: restore the TTL
                # frames ttl_fill deducted so the pulse keeps its full
                # requested duration across the xrun
                with self._lock:
                    np.maximum(self._high_for, before, out=self._high_for)
                if self._stop.is_set():
                    break  # closing: a failing device plays nothing more
                if lib.snd_pcm_recover(self._pcm.handle, int(wrote), 1) < 0:
                    break
            elif wrote < self.frame_size:
                # short write (signal/buffer boundary): frames beyond
                # ``wrote`` were dropped, so give back the high frames
                # ttl_fill deducted for the unplayed region — otherwise an
                # armed pulse ends up shorter than its requested duration
                with self._lock:
                    np.maximum(
                        self._high_for,
                        np.maximum(before - int(wrote), 0),
                        out=self._high_for,
                    )
