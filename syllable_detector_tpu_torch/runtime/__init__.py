"""L4/L5 — runtime: the device IO backends (simulated audio, ALSA,
PulseAudio, Arduino), the offline CSV contract (``track_detector``), the
live pipeline (``processor``), the crash-isolated detector (``resilient``)
and the multi-process sharded bank (``shard_bank``)."""

from syllable_detector_tpu_torch.runtime.track_detector import TrackDetector
from syllable_detector_tpu_torch.runtime.ring_buffer import RingBuffer, native_available
from syllable_detector_tpu_torch.runtime.arduino import (
    ArduinoIO,
    ArduinoPin,
    ArduinoState,
    ArduinoError,
    NativeFirmwareTransport,
    SerialTransport,
    SimulatedArduinoTransport,
)
from syllable_detector_tpu_torch.runtime.audio_io import (
    AudioDevice,
    list_devices,
    register_device,
    add_device_change_listener,
    SimulatedAudioInput,
    SimulatedAudioOutput,
)
from syllable_detector_tpu_torch.runtime.processor import (
    Processor,
    ProcessorEntry,
    AudioTTLOutput,
    ArduinoTTLOutput,
    CallbackOutput,
)

__all__ = [
    "TrackDetector",
    "RingBuffer",
    "native_available",
    "ArduinoIO",
    "ArduinoPin",
    "ArduinoState",
    "ArduinoError",
    "NativeFirmwareTransport",
    "SerialTransport",
    "SimulatedArduinoTransport",
    "AudioDevice",
    "list_devices",
    "register_device",
    "add_device_change_listener",
    "SimulatedAudioInput",
    "SimulatedAudioOutput",
    "Processor",
    "ProcessorEntry",
    "AudioTTLOutput",
    "ArduinoTTLOutput",
    "CallbackOutput",
]
