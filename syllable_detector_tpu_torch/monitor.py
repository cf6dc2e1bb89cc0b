"""Live multi-channel monitor on PyTorch: the headless processor window.

Counterpart of ``syllable_detector_tpu.monitor`` (``main``,
``interactive_loop``): input channel i is paired with output channel i,
each channel gets a network (``-n`` is repeatable and cycled over the
channels), and the Processor pipeline runs over a simulated device (a WAV
looped per channel, or a synthetic tone) or a real capture device (ALSA or
PulseAudio), printing the channel table periodically and the TTL events at
the end. TTL pulses go to a simulated output, an Arduino, or a real ALSA or
PulseAudio playback device.

Usage:
  python -m syllable_detector_tpu_torch.monitor -n NET.txt -a IN.wav
      [--channels N] [--input sim|alsa[:DEV]|pulse[:DEV]]
      [--output audio|arduino|arduino-native|alsa|pulse]
      [--batched-drain [--wire-format float32|int16|mulaw8]]
      [--event-log EV.csv] [--duration SECONDS] [--realtime]
      [--device cuda|cpu]
  python -m syllable_detector_tpu_torch.monitor --list-devices
  python -m syllable_detector_tpu_torch.monitor --interactive [...]

``--interactive`` is the GUI's control loop as a REPL: load a network per
channel row, start and stop the processor, print the level table.

The device defaults to ``cuda``; without a card the monitor raises rather
than move to the CPU, which is only used when asked for (``--device cpu``).
A drain that fails is counted; the monitor reports the count and exits 1
if it is not zero.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import ConfigError, load_config
from syllable_detector_tpu_torch.runtime import alsa, audio_io, pulse
from syllable_detector_tpu_torch.runtime.arduino import (
    ArduinoIO,
    NativeFirmwareTransport,
    SimulatedArduinoTransport,
)
from syllable_detector_tpu_torch.runtime.audio_io import (
    SimulatedAudioInput,
    SimulatedAudioOutput,
)
from syllable_detector_tpu_torch.runtime.processor import (
    ArduinoTTLOutput,
    AudioTTLOutput,
    Processor,
    ProcessorEntry,
    csv_event_log,
)
from syllable_detector_tpu_torch.utils.wav import read_audio

__all__ = ["main", "interactive_loop"]


def _drain_grace(device: torch.device) -> float:
    """Final-drain timeout. On a card the first drain of a run may build
    the kernel with nvcc, so it gets a build-sized window."""
    return 300.0 if device.type == "cuda" else 10.0


def _buckets(text: str) -> tuple[int, ...]:
    return tuple(int(b) for b in text.split(","))


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="syllable-detector-torch-monitor")
    p.add_argument(
        "--list-devices",
        action="store_true",
        help="List the registered audio devices (ALSA PCMs and PulseAudio "
        "sources and sinks where their libraries exist) and exit.",
    )
    p.add_argument(
        "-n",
        "--net",
        action="append",
        default=[],
        help="Network file; repeat to give each channel its own network "
        "(cycled when fewer nets than channels).",
    )
    p.add_argument("-a", "--audio", help="WAV to stream (loops per channel).")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument(
        "--input",
        default="sim",
        metavar="sim|alsa[:DEV]|pulse[:DEV]",
        help="Capture source: 'sim' streams the WAV or a synthetic tone "
        "through the simulated device; 'alsa[:DEV]' / 'pulse[:DEV]' capture "
        "real audio (wall-clock paced; --audio is ignored).",
    )
    p.add_argument(
        "--output",
        choices=("audio", "arduino", "arduino-native", "alsa", "pulse"),
        default="audio",
        help="TTL sink: simulated audio or Arduino, 'arduino-native' (the "
        "C++ firmware state machine via ctypes), or a real ALSA or "
        "PulseAudio playback device rendering the TTL waveform.",
    )
    p.add_argument(
        "--batched-drain",
        action="store_true",
        help="Drain all channels in one DetectorBank round (one kernel "
        "launch with one net per channel) instead of per-lane drains; "
        "lanes group by pipeline geometry.",
    )
    p.add_argument(
        "--wire-format",
        choices=("float32", "int16", "mulaw8"),
        default="float32",
        help="Batched-drain host->device wire: int16 halves the bytes "
        "(capture-exact PCM), mulaw8 quarters them (lossy companding). "
        "Only meaningful with --batched-drain.",
    )
    p.add_argument(
        "--method",
        choices=("fused", "matmul"),
        default=None,
        help="Drain method (default: fused for --batched-drain, matmul per "
        "lane).",
    )
    p.add_argument(
        "--buckets",
        type=_buckets,
        default=None,
        metavar="B[,B...]",
        help="Pinned drain-shape ladder of the batched bank, e.g. 128.",
    )
    p.add_argument(
        "--frame-size",
        type=int,
        default=None,
        help="Frames per capture callback (default: "
        f"{audio_io.DEFAULT_FRAME_SIZE} simulated, 64 ALSA or PulseAudio).",
    )
    p.add_argument(
        "--warm-up",
        action="store_true",
        help="Run every drain shape once before capture starts (builds the "
        "kernel on a card).",
    )
    p.add_argument("--duration", type=float, default=2.0, help="Seconds to run.")
    p.add_argument("--realtime", action="store_true", help="Pace to wall clock.")
    p.add_argument("--refresh", type=float, default=0.1, help="Table refresh (s).")
    p.add_argument(
        "--event-log",
        metavar="PATH",
        help="Append every live detection to PATH as the offline CLI's CSV "
        "(channel,sample,seconds,out0...) with sample-accurate stream indices.",
    )
    p.add_argument(
        "--interactive",
        action="store_true",
        help="REPL control loop: load CH NET | start | stop | table | "
        "devices | quit (the GUI flow).",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="Torch device to run on (default: cuda).",
    )
    return p


def _source(args, rate: float):
    """(source(ch, start, n), device rate): a WAV streams at its own rate
    (a mismatch adds a per-lane resampler), else a per-channel tone."""
    if args.audio:
        wav, wav_rate = read_audio(args.audio)
        mono = np.ascontiguousarray(wav[:, 0])
        if not len(mono):
            raise ValueError(f"{args.audio}: no samples.")

        def source(ch, start, n):
            return mono[(start + np.arange(n)) % len(mono)]

        return source, float(wav_rate)
    rng = np.random.default_rng(0)

    def source(ch, start, n):
        t = (start + np.arange(n)) / rate
        x = 0.4 * np.sin(2 * np.pi * (2500.0 + 700 * ch) * t)
        return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)

    return source, rate


def _torch_device(name: str) -> torch.device:
    """The run's device; a card that is asked for and absent raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    # full fp32 products, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _simulated_input(args, source, channels: int, device_rate: float) -> SimulatedAudioInput:
    return SimulatedAudioInput(
        source,
        channels=channels,
        sample_rate=device_rate,
        frame_size=args.frame_size or audio_io.DEFAULT_FRAME_SIZE,
        realtime=args.realtime,
        total_samples=int(args.duration * device_rate),
    )


def _capture_input(kind: str, name: str, args, rate: float):
    """A real capture device: ALSA or PulseAudio, ``name`` or the default."""
    frames = {"frame_size": args.frame_size} if args.frame_size else {}
    if kind == "alsa":
        return alsa.AlsaAudioInput(
            device=name or "default", channels=args.channels, sample_rate=rate, **frames
        )
    return pulse.PulseAudioInput(
        device=name or None, channels=args.channels, sample_rate=rate, **frames
    )


def _ttl_output(kind: str, channels: int, rate: float):
    """The TTL sink of ``--output``; a real device whose library is absent
    raises RuntimeError."""
    if kind == "audio":
        return AudioTTLOutput(SimulatedAudioOutput(channels=channels, sample_rate=rate))
    if kind in ("arduino", "arduino-native"):
        transport = (
            NativeFirmwareTransport() if kind == "arduino-native" else SimulatedArduinoTransport()
        )
        arduino = ArduinoIO(transport, startup_time=0.0)
        arduino.open()
        return ArduinoTTLOutput(arduino)
    if kind == "alsa":
        if not alsa.alsa_available():
            raise RuntimeError("libasound.so.2 is not available")
        return AudioTTLOutput(alsa.AlsaAudioOutput(channels=channels, sample_rate=rate))
    if not pulse.pulse_available():
        raise RuntimeError("libpulse-simple.so.0 is not available")
    return AudioTTLOutput(pulse.PulseAudioOutput(channels=channels, sample_rate=rate))


def _processor(args, interface, entries, output, event_log, device) -> Processor:
    return Processor(
        interface,
        entries,
        output,
        batched=args.batched_drain,
        method=args.method,
        event_log=event_log,
        bank_buckets=args.buckets,
        bank_transfer_dtype=args.wire_format,
        device=device,
    )


def _list_devices(out=print) -> int:
    """Register the ALSA and PulseAudio devices where their libraries exist
    (enumeration never breaks the listing) and print the registry."""
    for register in (alsa.register_alsa_devices, pulse.register_pulse_devices):
        try:
            register()
        except Exception:  # a broken sound stack still lists the rest
            pass
    devices = audio_io.list_devices()
    if not devices:
        out("No audio devices registered (simulated sources only).")
    for d in devices:
        out(
            f"{d.device_id}: {d.device_name} [{d.device_uid}] "
            f"in={d.streams_input} out={d.streams_output} rate={d.sample_rate_input}"
        )
    return 0


def interactive_loop(args, input_fn=input, out=print) -> int:
    """The GUI's control flow as a REPL (``input_fn`` and ``out`` can be
    injected). Commands:

      load CH NET.txt   assign a network to channel row CH
      start | stop      construct or tear down the Processor over the
                        simulated device (the WAV of ``--audio`` or a tone)
      table             print the level columns
      devices           list registered audio devices
      quit              stop and exit

    The Processor runs on ``args.device`` with the batched-drain, method,
    wire and bucket options of the command line.
    """
    device = _torch_device(args.device)
    rate = 44100.0
    configs: dict[int, object] = {}
    proc = None
    interface = None
    event_fh = None
    event_log = None
    if args.event_log:
        try:
            event_fh = open(args.event_log, "a")
        except OSError as e:
            out(f"Unable to open --event-log: {e}")
            return 1
        event_log = csv_event_log(event_fh)

    def stop():
        nonlocal proc
        if proc is None:
            out("not running")
            return
        # a finite replay gets a bounded grace to finish, so that counts are
        # deterministic; a realtime source stops at once
        if not args.realtime:
            interface.wait_until_done(timeout=5.0)
        proc.drain_pending(timeout=_drain_grace(device))
        proc.tear_down()
        out(f"stopped; detections per channel: {proc.lane_detections()}")
        if proc.drain_errors:
            out(f"drain errors: {proc.drain_errors} (first: {proc.first_drain_error})")
        proc = None

    out("interactive monitor — load CH NET | start | stop | table | devices | quit")
    while True:
        try:
            line = input_fn("> ")
        except (EOFError, KeyboardInterrupt):
            line = "quit"
        parts = line.strip().split()
        if not parts:
            continue
        cmd = parts[0].lower()
        if cmd == "quit":
            if proc is not None:
                stop()
            if event_fh is not None:
                event_fh.close()
            return 0
        if cmd == "devices":
            devices = audio_io.list_devices()
            if not devices:
                out("No audio devices registered (simulated sources only).")
            for d in devices:
                out(f"{d.device_id}: {d.device_name} [{d.device_uid}]")
        elif cmd == "load":
            if len(parts) != 3:
                out("usage: load CH NET.txt")
                continue
            try:
                ch = int(parts[1])
                cfg = load_config(parts[2])
            except (ValueError, ConfigError) as e:
                out(f"load failed: {e}")
                continue
            configs[ch] = cfg
            rate = cfg.sampling_rate
            out(f"channel {ch} <- {parts[2]} "
                f"({cfg.sampling_rate:.0f} Hz, threshold {cfg.thresholds[0]})")
        elif cmd == "start":
            if proc is not None:
                out("already running (stop first)")
                continue
            if not configs:
                out("no networks loaded (use: load CH NET.txt)")
                continue
            channels = max(configs) + 1
            try:
                source, device_rate = _source(args, rate)
            except (OSError, ValueError) as e:
                out(f"start failed: {e}")
                continue
            interface = _simulated_input(args, source, channels, device_rate)
            entries = [
                ProcessorEntry(input_channel=i, output_channel=i, config=configs.get(i),
                               resample_from=device_rate)
                for i in range(channels)
            ]
            output = AudioTTLOutput(SimulatedAudioOutput(channels=channels, sample_rate=rate))
            try:
                # a bad net surfaces here; a traceback would end the session
                proc = _processor(args, interface, entries, output, event_log, device)
                proc.set_up()
            except Exception as e:
                out(f"start failed: {type(e).__name__}: {e}")
                # set_up can fail midway, with the worker already started
                if proc is not None:
                    try:
                        proc.tear_down()
                    except Exception:
                        pass
                proc = None
                continue
            out(f"running: {len(proc.entries)} detector(s) over {channels} channel(s)")
        elif cmd == "stop":
            stop()
        elif cmd == "table":
            if proc is None:
                out("not running")
                continue
            out(f"{'chan':>4} {'in RMS':>10} {'max out':>10} {'age s':>8} "
                f"{'drops':>6} {'lost':>6}")
            for e, st in zip(proc.entries, proc.lane_stats()):
                i = e.input_channel
                rms = proc.get_input_for_channel(i) or 0.0
                o = proc.get_output_for_channel(i) or 0.0
                age = st["last_audio_age_s"]
                age_s = f"{age:>8.1f}" if age is not None else f"{'-':>8}"
                out(f"{i:>4} {rms:>10.4f} {o:>10.4f} {age_s} "
                    f"{st['overflows']:>6} {st['capture_lost_samples']:>6}")
        else:
            out(f"unknown command {cmd!r}")


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.interactive:
        return interactive_loop(args)
    if args.list_devices:
        return _list_devices()
    if not args.net:
        parser.error("the following arguments are required: -n/--net")
    device = _torch_device(args.device)

    try:
        configs = [load_config(n) for n in args.net]
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1
    rate = configs[0].sampling_rate
    device_rate = rate
    kind, _, dev_name = args.input.partition(":")
    if kind in ("alsa", "pulse"):
        # real capture: any rate mismatch goes to the lane resampler, and the
        # stream runs for --duration of wall time
        interface = _capture_input(kind, dev_name, args, rate)
        args.realtime = True
        if args.audio:
            print(
                f"warning: --audio {args.audio} is ignored with --input {args.input} "
                "(real capture streams the device)",
                file=sys.stderr,
            )
    elif kind == "sim":
        try:
            source, device_rate = _source(args, rate)
        except (OSError, ValueError) as e:
            print(f"Unable to read {args.audio}: {e}", file=sys.stderr)
            return 1
        interface = _simulated_input(args, source, args.channels, device_rate)
    else:
        print(f"Unknown --input {args.input!r}.", file=sys.stderr)
        return 1
    entries = [
        ProcessorEntry(
            input_channel=i,
            output_channel=i,
            config=configs[i % len(configs)],
            resample_from=device_rate,
        )
        for i in range(args.channels)
    ]

    try:
        output = _ttl_output(args.output, args.channels, rate)
    except RuntimeError as e:
        print(f"Unable to open {args.output} output: {e}", file=sys.stderr)
        return 1

    event_fh = None
    event_log = None
    if args.event_log:
        try:
            event_fh = open(args.event_log, "a")
        except OSError as e:
            print(f"Unable to open --event-log: {e}", file=sys.stderr)
            return 1
        event_log = csv_event_log(event_fh)

    try:
        proc = _processor(args, interface, entries, output, event_log, device)
    except ValueError as e:
        print(f"Invalid network configuration: {e}", file=sys.stderr)
        return 1
    drain_timeout = _drain_grace(device)

    if args.warm_up:
        n = proc.warm_up()
        print(f"warm-up ran {n} drain shapes", file=sys.stderr)

    try:
        proc.set_up()
    except Exception as e:
        # real device open failures (no card, busy PCM) exit cleanly
        print(f"Unable to start audio: {e}", file=sys.stderr)
        return 1

    last_rms = [0.0] * args.channels
    last_out = [0.0] * args.channels
    print(f"{'chan':>4} {'in RMS':>10} {'max out':>10} {'age s':>8} {'lost':>6}")

    def print_table():
        by_chan = {s["input_channel"]: s for s in proc.lane_stats()}
        cols = []
        for i in range(args.channels):
            rms = proc.get_input_for_channel(i)
            out = proc.get_output_for_channel(i)
            # hold the last value when nothing arrived since the last refresh
            if rms is not None:
                last_rms[i] = rms
            if out is not None:
                last_out[i] = out
            age = by_chan.get(i, {}).get("last_audio_age_s")
            age_s = f"{age:>8.1f}" if age is not None else f"{'-':>8}"
            lost = by_chan.get(i, {}).get("capture_lost_samples", 0)
            cols.append(f"{i:>4} {last_rms[i]:>10.4f} {last_out[i]:>10.4f} {age_s} {lost:>6}")
        print("\n".join(cols))

    # wall-clock backstop: a realtime run lasts --duration; a replay runs as
    # fast as it drains, so its cap only guards against a hung source
    wall_cap = (
        args.duration
        if args.realtime
        else max(60.0, 10.0 * args.duration) + drain_timeout
    )
    t_end = time.monotonic() + wall_cap
    stream_done = False
    try:
        while (left := t_end - time.monotonic()) > 0:
            # a real device never finishes: its wait sleeps the whole timeout
            if interface.wait_until_done(timeout=min(args.refresh, left)):
                stream_done = True
                break
            print_table()
    except KeyboardInterrupt:
        pass
    if not args.realtime and not stream_done:
        print(
            f"warning: stream not finished after the {wall_cap:.0f} s wall "
            "cap; results below cover only the audio processed so far",
            file=sys.stderr,
        )
    proc.drain_pending(timeout=drain_timeout)
    print_table()
    proc.tear_down()

    print(f"detections per channel: {proc.lane_detections()}")
    if args.output == "audio":
        print(f"TTL events: {len(output.interface.events)}")
    elif args.output == "arduino":
        print(f"Arduino events: {len(output.arduino.transport.events)}")
    elif args.output == "arduino-native":
        print(f"Arduino events: {len(output.arduino.transport.drain_events())}")
    if event_fh is not None:
        event_fh.close()
        print(f"event log appended to {args.event_log}", file=sys.stderr)
    if proc.drain_errors:
        print(
            f"drain errors: {proc.drain_errors} (first: {proc.first_drain_error})",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
