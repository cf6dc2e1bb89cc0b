"""Arduino serial TTL backend: protocol client + simulated firmware.

Re-implements the reference's ArduinoIO (reference:
SyllableDetector/ArduinoIO.swift:196-656), a client of the MATLAB-ArduinoIO
serial protocol spoken by Arduino/Arduino.ino. Protocol bytes (2-3 ASCII
bytes per command; Arduino.ino:90-200):

  * query sketch:   "99"                      -> println(sketch id)
  * set pin mode:   [48, 97+pin, 48+mode]     (mode 0=input, 1=output)
  * digital read:   [49, 97+pin]              -> println(0|1)
  * digital write:  [50, 97+pin, 48+value]
  * analog read:    [51, 97+pin]              -> println(0..1023)
  * analog write:   [52, 97+pin, value_byte]
  * digital pulse:  [53, 97+pin]              (1 ms high pulse)

State machine mirrors the reference: closed -> waitingToOpen (2 s startup
window during which commands queue, ArduinoIO.swift:12, 298-331) -> opened
after the sketch handshake, or error. Request timeout 0.5 s
(ArduinoIO.swift:13, 602-635). Close drives configured pins low first
(ArduinoIO.swift:370-390).

Real serial hardware is platform-specific; the transport is pluggable. The
bundled :class:`SimulatedArduinoTransport` implements the firmware state
machine so the full client path is testable, and a pyserial transport slot
is provided for real devices.
"""

from __future__ import annotations

import threading
import time
from enum import Enum
from typing import Callable, Optional

__all__ = [
    "ArduinoError",
    "ArduinoPin",
    "ArduinoState",
    "ArduinoIO",
    "SimulatedArduinoTransport",
    "NativeFirmwareTransport",
    "SerialTransport",
]

STARTUP_TIME = 2.0  # ArduinoIO.swift:12
TIMEOUT_DURATION = 0.5  # ArduinoIO.swift:13


class ArduinoError(Exception):
    pass


class ArduinoPin(Enum):
    UNASSIGNED = -1
    INPUT = 0
    OUTPUT = 1


class ArduinoState(Enum):
    CLOSED = "closed"
    OPENED = "opened"
    WAITING_TO_OPEN = "waitingToOpen"
    ERROR = "error"
    UNINITIALIZED = "uninitialized"


class Transport:
    """Byte transport to the device (serial port abstraction)."""

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def read_line(self, timeout: float) -> Optional[bytes]:
        """Read one println-delimited response, or None on timeout."""
        raise NotImplementedError

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass


class SimulatedArduinoTransport(Transport):
    """In-process implementation of the Arduino.ino state machine
    (Arduino.ino:43-324) for tests and the simulated live pipeline."""

    def __init__(self, sketch_id: int = 0, startup_delay: float = 0.0):
        self.pins: dict[int, str] = {}
        self.digital: dict[int, int] = {}
        self.analog_out: dict[int, int] = {}
        self.analog_in: dict[int, int] = {}  # test-settable AI values
        self.events: list[tuple[float, str, int, int]] = []  # (t, kind, pin, value)
        self._sketch_id = sketch_id
        self._startup_delay = startup_delay
        self._opened_at: Optional[float] = None
        self._responses: list[bytes] = []
        self._state = -1
        self._pin = 0
        self._lock = threading.Lock()

    # -- firmware state machine (Arduino.ino:85-324) ------------------------

    def write(self, data: bytes) -> None:
        with self._lock:
            # model the firmware boot window: bytes arriving before
            # ``startup_delay`` has elapsed after open() are lost, exactly
            # like a real board still in its bootloader (the reason the
            # client queues commands for 2 s, ArduinoIO.swift:298-331)
            if self._startup_delay > 0:
                t0 = self._opened_at
                if t0 is None or time.monotonic() < t0 + self._startup_delay:
                    return
            for val in data:
                self._step(val)

    def _emit(self, value: int) -> None:
        self._responses.append(f"{value}\r\n".encode())

    def _record(self, kind: str, pin: int, value: int) -> None:
        self.events.append((time.monotonic(), kind, pin, value))

    def _step(self, val: int) -> None:
        s = self._state
        if s == -1:
            if 47 < val < 90:
                s = 10 * (val - 48)
            if (50 < s < 90) or (s > 90 and s not in (340, 400)):
                s = -1
            self._state = s
            return
        if s == 0:  # pin mode: await pin
            if 98 < val < 167:
                self._pin = val - 97
                self._state = 1
            else:
                self._state = -1
            return
        if s == 1:  # pin mode: await value
            if 47 < val < 50:
                mode = "input" if val == 48 else "output"
                self.pins[self._pin] = mode
                self._record("mode", self._pin, val - 48)
            self._state = -1
            return
        if s == 10:  # digital read
            if 98 < val < 167:
                pin = val - 97
                self._emit(self.digital.get(pin, 0))
            self._state = -1
            return
        if s == 20:  # digital write: await pin
            if 98 < val < 167:
                self._pin = val - 97
                self._state = 21
            else:
                self._state = -1
            return
        if s == 21:  # digital write: await value
            if 47 < val < 50:
                self.digital[self._pin] = val - 48
                self._record("digital", self._pin, val - 48)
            self._state = -1
            return
        if s == 30:  # analog read
            if 96 < val < 113:
                pin = val - 97
                self._emit(self.analog_in.get(pin, 0))
            self._state = -1
            return
        if s == 40:  # analog write: await pin
            if 98 < val < 167:
                self._pin = val - 97
                self._state = 41
            else:
                self._state = -1
            return
        if s == 41:  # analog write: value is the raw byte
            self.analog_out[self._pin] = val
            self._record("analog", self._pin, val)
            self._state = -1
            return
        if s == 50:  # digital pulse (1 ms high)
            if 98 < val < 167:
                pin = val - 97
                self.digital[pin] = 1
                self._record("pulse", pin, 1)
                self.digital[pin] = 0
            self._state = -1
            return
        if s == 90:  # query sketch: second '9'
            if val == 57:
                self._emit(self._sketch_id)
            self._state = -1
            return
        self._state = -1

    def read_line(self, timeout: float) -> Optional[bytes]:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._responses:
                    return self._responses.pop(0)
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.001)

    def open(self) -> None:
        self._opened_at = time.monotonic()


class SerialTransport(Transport):
    """Real USB-serial transport via pyserial (115200 baud like the
    reference, ArduinoIO.swift:307). pyserial is optional; this raises a
    clear error when it is not installed."""

    def __init__(self, port: str, baudrate: int = 115200):
        try:
            import serial  # type: ignore
        except ImportError as e:  # pragma: no cover - optional dependency
            raise ArduinoError(
                "pyserial is required for real serial hardware; install it or "
                "use SimulatedArduinoTransport"
            ) from e
        self._serial_mod = serial
        self.port = port
        self.baudrate = baudrate
        self._port = None

    def open(self) -> None:
        self._port = self._serial_mod.Serial(self.port, self.baudrate, timeout=0)

    def close(self) -> None:
        if self._port is not None:
            self._port.close()
            self._port = None

    def write(self, data: bytes) -> None:
        self._port.write(data)

    def read_line(self, timeout: float):
        deadline = time.monotonic() + timeout
        buf = b""
        while time.monotonic() < deadline:
            chunk = self._port.read(64)
            if chunk:
                buf += chunk
                if b"\n" in buf:
                    return buf.split(b"\n", 1)[0] + b"\n"
            else:
                time.sleep(0.001)
        return None


class NativeFirmwareTransport(Transport):
    """The device-side state machine as NATIVE C++ (native/
    arduino_firmware.cpp — the host-compiled counterpart of the
    reference's Arduino/Arduino.ino), driven through the same byte-stream
    Transport contract as the real serial port. Auto-builds the shared
    library on first use (like runtime.ring_buffer); raises a clear error
    when no C++ toolchain is available.
    """

    _lib = None
    _load_lock = threading.Lock()

    @classmethod
    def _load(cls):
        with cls._load_lock:  # one build at a time; a second CDLL of a half-written
            # .so would fail with an invalid-ELF OSError
            if cls._lib is not None:
                return cls._lib
            return cls._load_locked()

    @classmethod
    def _load_locked(cls):
        import ctypes
        import os

        from syllable_detector_tpu_torch.utils.native_build import (
            NATIVE_BUILD,
            NATIVE_SRC,
            NativeBuildError,
            ensure_native_library,
        )

        path = os.path.join(NATIVE_BUILD, "libsdfirmware.so")
        try:
            ensure_native_library(
                os.path.join(NATIVE_SRC, "arduino_firmware.cpp"),
                path,
                extra_flags=("-Wextra",),
            )
        except NativeBuildError as e:
            if e.stderr:
                raise ArduinoError(
                    "native firmware compile failed:\n" + e.stderr[:2000]
                ) from e
            raise ArduinoError(
                f"building the native firmware needs a C++ toolchain "
                f"({e}); use SimulatedArduinoTransport"
            ) from e
        lib = ctypes.CDLL(path)
        lib.sdfw_new.restype = ctypes.c_void_p
        lib.sdfw_new.argtypes = [ctypes.c_int32]
        lib.sdfw_free.argtypes = [ctypes.c_void_p]
        lib.sdfw_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.sdfw_read.restype = ctypes.c_int32
        lib.sdfw_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ]
        for fn in ("sdfw_pin_mode", "sdfw_digital", "sdfw_analog_out"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_int32
            f.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sdfw_set_analog_in.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.sdfw_events.restype = ctypes.c_int32
        lib.sdfw_events.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        cls._lib = lib
        return lib

    def __init__(self, sketch_id: int = 0):
        self._libh = self._load()
        self._fw = self._libh.sdfw_new(sketch_id)
        self._buf = b""
        # serialize native calls: ArduinoIO's startup Timer thread can
        # replay queued commands while the app thread reads — the native
        # deque/parser are not thread-safe (the Python sim holds the same
        # lock for the same reason)
        self._lock = threading.Lock()

    def _handle(self):
        if not self._fw:
            raise ArduinoError("native firmware transport is disposed")
        return self._fw

    def open(self) -> None:
        pass

    def close(self) -> None:
        # keep the native state observable after close (tests verify the
        # close-drives-pins-low contract post-close, like the Python sim);
        # the handle is freed on garbage collection / dispose()
        pass

    def dispose(self) -> None:
        with self._lock:
            if self._fw:
                self._libh.sdfw_free(self._fw)
                self._fw = None

    def __del__(self):  # pragma: no cover - interpreter teardown timing
        try:
            self.dispose()
        except Exception:
            pass

    def write(self, data: bytes) -> None:
        with self._lock:
            self._libh.sdfw_write(self._handle(), bytes(data), len(data))

    def read_line(self, timeout: float):
        import ctypes

        deadline = time.monotonic() + timeout
        while True:
            out = ctypes.create_string_buffer(256)
            with self._lock:
                n = self._libh.sdfw_read(self._handle(), out, 256)
            if n:
                self._buf += out.raw[:n]
            if b"\n" in self._buf:
                line, self._buf = self._buf.split(b"\n", 1)
                return line + b"\n"
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.001)

    # -- native-side observers (tests / TTL verification) -------------------

    def pin_mode(self, pin: int) -> int:
        with self._lock:
            return self._libh.sdfw_pin_mode(self._handle(), pin)

    def digital(self, pin: int) -> int:
        with self._lock:
            return self._libh.sdfw_digital(self._handle(), pin)

    def analog_out(self, pin: int) -> int:
        with self._lock:
            return self._libh.sdfw_analog_out(self._handle(), pin)

    def set_analog_in(self, pin: int, value: int) -> None:
        with self._lock:
            self._libh.sdfw_set_analog_in(self._handle(), pin, value)

    def drain_events(self) -> list[tuple[int, int, int]]:
        import ctypes

        events = []
        buf = (ctypes.c_int32 * 768)()
        while True:  # the native log is drained in bounded chunks
            with self._lock:
                n = self._libh.sdfw_events(self._handle(), buf, 768)
            events.extend(
                (buf[i], buf[i + 1], buf[i + 2]) for i in range(0, n, 3)
            )
            if n < 768:
                return events


class ArduinoIO:
    """Client state machine (ArduinoIO.swift:196-656)."""

    def __init__(self, transport: Transport, startup_time: float = STARTUP_TIME):
        self.transport = transport
        self.state = ArduinoState.UNINITIALIZED
        self.pins = {p: ArduinoPin.UNASSIGNED for p in range(2, 70)}
        self.sketch: Optional[int] = None
        self._startup_time = startup_time
        self._queue: list[Callable[[], None]] = []
        self._lock = threading.RLock()
        self._open_timer: Optional[threading.Timer] = None
        self.on_error: Optional[Callable[[Exception, bool], None]] = None

    # -- lifecycle (ArduinoIO.swift:298-353) --------------------------------

    def open(self) -> None:
        with self._lock:
            if self.state != ArduinoState.UNINITIALIZED:
                raise ArduinoError("Port already opened")
            self.transport.open()
            self.state = ArduinoState.WAITING_TO_OPEN
            if self._startup_time > 0:
                self._open_timer = threading.Timer(self._startup_time, self._complete_open)
                self._open_timer.daemon = True
                self._open_timer.start()
            else:
                self._complete_open()

    def _complete_open(self) -> None:
        with self._lock:
            if self.state != ArduinoState.WAITING_TO_OPEN:
                return
            # sketch handshake: "99" -> id (ArduinoIO.swift:329-330, 557-581)
            # Transport errors (port yanked during the startup window) must
            # land in ERROR with on_error fired — an escaping exception on
            # this Timer thread would leave the client WAITING_TO_OPEN
            # forever, queueing commands into a black hole.
            try:
                self.transport.write(b"99")
                line = self.transport.read_line(TIMEOUT_DURATION)
            except Exception as e:
                self.state = ArduinoState.ERROR
                if self.on_error:
                    self.on_error(
                        e if isinstance(e, ArduinoError)
                        else ArduinoError(f"handshake failed: {e}"),
                        True,
                    )
                return
            if line is None:
                self.state = ArduinoState.ERROR
                if self.on_error:
                    self.on_error(ArduinoError("handshake timeout"), True)
                return
            try:
                self.sketch = int(line.strip())
            except ValueError:
                self.sketch = None
            if self.sketch is None:
                self.state = ArduinoState.ERROR
                if self.on_error:
                    self.on_error(ArduinoError("unknown sketch"), True)
                return
            self.state = ArduinoState.OPENED
            queued, self._queue = self._queue, []
        for fn in queued:
            fn()

    def close(self) -> None:
        with self._lock:
            if self._open_timer is not None:
                self._open_timer.cancel()
            if self.state == ArduinoState.OPENED:
                # drive all configured output pins low (ArduinoIO.swift:370-390)
                for pin, mode in self.pins.items():
                    if mode == ArduinoPin.OUTPUT:
                        try:
                            self._send_digital(pin, False)
                        except ArduinoError:
                            pass
            self.transport.close()
            self.state = ArduinoState.CLOSED

    def _can_interact(self) -> bool:
        return self.state in (ArduinoState.OPENED, ArduinoState.WAITING_TO_OPEN)

    def _run_or_queue(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if self.state == ArduinoState.WAITING_TO_OPEN:
                self._queue.append(fn)
                return
        fn()

    @staticmethod
    def _valid_pin(pin: int) -> bool:
        return 2 <= pin <= 69  # ArduinoIO.swift:404

    # -- pin operations (ArduinoIO.swift:407-556) ---------------------------

    def set_pin_mode(self, pin: int, mode: ArduinoPin) -> None:
        if not self._can_interact():
            raise ArduinoError("Port not open")
        if not self._valid_pin(pin):
            raise ArduinoError(f"Invalid pin ({pin})")
        if mode == ArduinoPin.UNASSIGNED:
            raise ArduinoError("Invalid mode")
        self._run_or_queue(
            lambda: self.transport.write(bytes([48, 97 + pin, 48 + mode.value]))
        )
        self.pins[pin] = mode

    def _send_digital(self, pin: int, value: bool) -> None:
        self.transport.write(bytes([50, 97 + pin, 48 + (1 if value else 0)]))

    def write_digital(self, pin: int, value: bool) -> None:
        if not self._can_interact():
            raise ArduinoError("Port not open")
        if not self._valid_pin(pin):
            raise ArduinoError(f"Invalid pin ({pin})")
        if self.pins[pin] != ArduinoPin.OUTPUT:
            raise ArduinoError("Invalid mode")
        self._run_or_queue(lambda: self._send_digital(pin, value))

    def read_digital(self, pin: int) -> Optional[bool]:
        if self.state != ArduinoState.OPENED:
            raise ArduinoError("Port not open")
        if not self._valid_pin(pin):
            raise ArduinoError(f"Invalid pin ({pin})")
        if self.pins[pin] != ArduinoPin.INPUT:
            raise ArduinoError("Invalid mode")
        self.transport.write(bytes([49, 97 + pin]))
        line = self.transport.read_line(TIMEOUT_DURATION)
        if line is None:
            return None
        return bool(int(line.strip()))

    def write_analog(self, pin: int, value: int) -> None:
        if not self._can_interact():
            raise ArduinoError("Port not open")
        if not ((2 <= pin <= 13) or (44 <= pin <= 46)):  # ArduinoIO.swift:492
            raise ArduinoError(f"Invalid pin ({pin})")
        if self.pins[pin] != ArduinoPin.OUTPUT:
            raise ArduinoError("Invalid mode")
        self._run_or_queue(
            lambda: self.transport.write(bytes([52, 97 + pin, value & 0xFF]))
        )

    def read_analog(self, pin: int) -> Optional[int]:
        if self.state != ArduinoState.OPENED:
            raise ArduinoError("Port not open")
        if not (0 <= pin <= 15):  # ArduinoIO.swift:514
            raise ArduinoError(f"Invalid pin ({pin})")
        if pin >= 2 and self.pins[pin] != ArduinoPin.INPUT:
            raise ArduinoError("Invalid mode")
        self.transport.write(bytes([51, 97 + pin]))
        line = self.transport.read_line(TIMEOUT_DURATION)
        if line is None:
            return None
        return int(line.strip())

    def pulse_digital(self, pin: int) -> None:
        """1 ms hardware pulse (Arduino.ino s=50 opcode)."""
        if not self._can_interact():
            raise ArduinoError("Port not open")
        if not self._valid_pin(pin):
            raise ArduinoError(f"Invalid pin ({pin})")
        if self.pins[pin] != ArduinoPin.OUTPUT:
            raise ArduinoError("Invalid mode")
        self._run_or_queue(lambda: self.transport.write(bytes([53, 97 + pin])))
