"""A route to the JAX package's framework-free host modules that loads no jax.

``runtime/ring_buffer.py`` (the native SPSC ring, its block writer and the
native drain stager),
``runtime/audio_io.py`` (the audio interfaces and the simulated devices) and
``runtime/arduino.py`` (the Arduino TTL transports) import no jax
themselves, but importing them by their package path runs
``syllable_detector_tpu/runtime/__init__.py``, which loads the JAX detector.
So each file is loaded here by its path, under a private module name.

The classes are therefore other objects than the JAX package's own: no
``isinstance`` check may cross the two packages. Capture and playback
through ALSA and PulseAudio import ``audio_io`` by its package path and are
not reachable this way yet.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import syllable_detector_tpu

__all__ = [
    "ring_buffer",
    "audio_io",
    "arduino",
    "RingBuffer",
    "RingBlockWriter",
    "DrainStager",
    "AudioInputInterface",
    "AudioOutputInterface",
    "SimulatedAudioInput",
    "SimulatedAudioOutput",
    "ArduinoIO",
    "ArduinoPin",
    "SimulatedArduinoTransport",
    "NativeFirmwareTransport",
]

_RUNTIME = Path(syllable_detector_tpu.__file__).resolve().parent / "runtime"


def _load(name: str):
    """Load ``syllable_detector_tpu/runtime/<name>.py`` as ``<this module>_<name>``."""
    module_name = f"{__name__}_{name}"
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, _RUNTIME / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    # registered before it runs, as an import would: dataclasses look their
    # module up in sys.modules
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module


ring_buffer = _load("ring_buffer")
audio_io = _load("audio_io")
arduino = _load("arduino")

RingBuffer = ring_buffer.RingBuffer
RingBlockWriter = ring_buffer.RingBlockWriter
DrainStager = ring_buffer.DrainStager
AudioInputInterface = audio_io.AudioInputInterface
AudioOutputInterface = audio_io.AudioOutputInterface
SimulatedAudioInput = audio_io.SimulatedAudioInput
SimulatedAudioOutput = audio_io.SimulatedAudioOutput
ArduinoIO = arduino.ArduinoIO
ArduinoPin = arduino.ArduinoPin
SimulatedArduinoTransport = arduino.SimulatedArduinoTransport
NativeFirmwareTransport = arduino.NativeFirmwareTransport
