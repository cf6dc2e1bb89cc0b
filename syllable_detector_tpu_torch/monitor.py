"""Live multi-channel monitor on PyTorch: the headless processor window.

Counterpart of ``syllable_detector_tpu.monitor`` (``main``): input channel i
is paired with output channel i, each channel gets a network (``-n`` is
repeatable and cycled over the channels), and the Processor pipeline runs
over a simulated device (a WAV looped per channel, or a synthetic tone),
printing the channel table periodically and the TTL events at the end.

Usage:
  python -m syllable_detector_tpu_torch.monitor -n NET.txt -a IN.wav
      [--channels N] [--output audio|arduino|arduino-native]
      [--batched-drain [--wire-format float32|int16|mulaw8]]
      [--event-log EV.csv] [--duration SECONDS] [--realtime]
      [--device cuda|cpu]

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
from syllable_detector_tpu_torch.runtime import audio_io
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

__all__ = ["main"]


def _drain_grace(device: torch.device) -> float:
    """Final-drain timeout. On a card the first drain of a run may build
    the kernel with nvcc, so it gets a build-sized window."""
    return 300.0 if device.type == "cuda" else 10.0


def _buckets(text: str) -> tuple[int, ...]:
    return tuple(int(b) for b in text.split(","))


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="syllable-detector-torch-monitor")
    p.add_argument(
        "-n",
        "--net",
        action="append",
        required=True,
        help="Network file; repeat to give each channel its own network "
        "(cycled when fewer nets than channels).",
    )
    p.add_argument("-a", "--audio", help="WAV to stream (loops per channel).")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument(
        "--input",
        default="sim",
        metavar="sim",
        help="Capture source: 'sim' streams the WAV or a synthetic tone "
        "through the simulated device (the only source ported so far).",
    )
    p.add_argument(
        "--output",
        choices=("audio", "arduino", "arduino-native"),
        default="audio",
        help="TTL sink: simulated audio or Arduino, or 'arduino-native' "
        "(the C++ firmware state machine via ctypes).",
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
        default=audio_io.DEFAULT_FRAME_SIZE,
        help="Samples per channel per simulated capture callback.",
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


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    # full fp32 products, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.input != "sim":
        print(
            f"--input {args.input!r} is not available: only the simulated "
            "device is ported so far.",
            file=sys.stderr,
        )
        return 1

    try:
        configs = [load_config(n) for n in args.net]
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1
    rate = configs[0].sampling_rate
    try:
        source, device_rate = _source(args, rate)
    except (OSError, ValueError) as e:
        print(f"Unable to read {args.audio}: {e}", file=sys.stderr)
        return 1
    interface = SimulatedAudioInput(
        source,
        channels=args.channels,
        sample_rate=device_rate,
        frame_size=args.frame_size,
        realtime=args.realtime,
        total_samples=int(args.duration * device_rate),
    )
    entries = [
        ProcessorEntry(
            input_channel=i,
            output_channel=i,
            config=configs[i % len(configs)],
            resample_from=device_rate,
        )
        for i in range(args.channels)
    ]

    if args.output == "audio":
        output = AudioTTLOutput(SimulatedAudioOutput(channels=args.channels, sample_rate=rate))
    else:
        transport = (
            NativeFirmwareTransport()
            if args.output == "arduino-native"
            else SimulatedArduinoTransport()
        )
        arduino = ArduinoIO(transport, startup_time=0.0)
        arduino.open()
        output = ArduinoTTLOutput(arduino)

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
        proc = Processor(
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
        while time.monotonic() < t_end:
            if interface.wait_until_done(timeout=args.refresh):
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
    else:
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
