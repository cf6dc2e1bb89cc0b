"""The port's live monitor against the JAX package's, and the live path's
independence from JAX.

Both monitors stream the same WAV through 3 channels with 3 distinct nets
and write an event log. The "detections per channel:" line must match, and
the sorted event logs must be identical in columns 1-3 (outputs within
rtol=1e-3, atol=2e-4). TTL event counts are not compared: they depend on
how the worker coalesces drain rounds. The same holds for a scripted
``--interactive`` session against the JAX ``interactive_loop``, and for
real-capture input (a fake libasound or libpulse-simple replaying the WAV)
against the simulated input; ``--list-devices`` lists what the sound
libraries register, and never fails without them.
"""

import argparse
import contextlib
import io

import numpy as np
import pytest
import torch

import syllable_detector_tpu.monitor as jax_monitor
from syllable_detector_tpu.config.model_format import save_config
from syllable_detector_tpu.utils.wav import write_wav
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch import monitor as port_monitor
from syllable_detector_tpu_torch.runtime import alsa, audio_io, pulse
from test_alsa import FakeAlsa
from test_torch_cli import blocked_run
from test_torch_pulse import PortFakePulseAsync

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("monitor")
    audio = fixtures.chirp_audio(1.0, 31)
    nets = []
    for seed in (31, 32, 33):
        path = str(tmp / f"net{seed}.txt")
        save_config(fixtures.pick_thresholds(fixtures.sample_geometry_config(seed), audio), path)
        nets.append(path)
    wav = str(tmp / "in.wav")
    write_wav(wav, audio, fixtures.RATE, dtype="float32")
    return tmp, nets, wav


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return out.getvalue().splitlines()


def events(path):
    with open(path) as fh:
        return sorted(
            (line.split(",") for line in fh.read().splitlines()),
            key=lambda r: (int(r[0]), int(r[1])),
        )


def assert_same_events(got_path, want_path, counts):
    g, w = events(got_path), events(want_path)
    assert len(g) == sum(counts) and all(c > 0 for c in counts)
    assert [r[:3] for r in g] == [r[:3] for r in w]
    np.testing.assert_allclose(
        np.array([r[3:] for r in g], np.float64),
        np.array([r[3:] for r in w], np.float64),
        rtol=1e-3, atol=2e-4,
    )


def detections(lines):
    line = [s for s in lines if s.startswith("detections per channel:")]
    assert len(line) == 1, lines
    return eval(line[0].split(":", 1)[1])


@pytest.mark.parametrize(
    "mode", [[], ["--batched-drain"], ["--batched-drain", "--wire-format", "int16"]],
    ids=["per-lane", "batched", "batched-int16"],
)
def test_monitor_matches_jax(files, mode):
    tmp, nets, wav = files
    name = "-".join(mode) or "per-lane"
    argv = [a for n in nets for a in ("-n", n)] + [
        "-a", wav, "--channels", "3", "--duration", "1", "--refresh", "5", *mode,
    ]
    port_log, jax_log = str(tmp / f"port{name}.csv"), str(tmp / f"jax{name}.csv")
    got = run(port_monitor.main, argv + ["--device", "cpu", "--event-log", port_log])
    want = run(jax_monitor.main, argv + ["--event-log", jax_log])
    line = [s for s in got if s.startswith("detections per channel:")]
    assert line == [s for s in want if s.startswith("detections per channel:")]
    counts = eval(line[0].split(":", 1)[1])
    assert all(c > 0 for c in counts)
    g, w = events(port_log), events(jax_log)
    assert len(g) == sum(counts)
    assert [r[:3] for r in g] == [r[:3] for r in w]
    np.testing.assert_allclose(
        np.array([r[3:] for r in g], np.float64),
        np.array([r[3:] for r in w], np.float64),
        rtol=1e-3, atol=2e-4,
    )


def test_monitor_options(files):
    tmp, nets, wav = files
    base = ["-n", nets[0], "-a", wav, "--channels", "2", "--duration", "0.5", "--refresh", "5"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_monitor.main(base)
    out = run(
        port_monitor.main,
        base + ["--device", "cpu", "--batched-drain", "--method", "matmul", "--buckets", "8,32",
                "--frame-size", "2048", "--output", "arduino", "--warm-up"],
    )
    assert out[-2].startswith("detections per channel:") and out[-1].startswith("Arduino events:")
    with contextlib.redirect_stderr(io.StringIO()):
        assert port_monitor.main(base + ["--device", "cpu", "--input", "alsa"]) == 1
        assert port_monitor.main(["-n", str(tmp / "missing.txt"), "--device", "cpu"]) == 1
        assert port_monitor.main(base + ["--device", "cpu", "--input", "jack"]) == 1
        with pytest.raises(SystemExit):
            port_monitor.main(["--device", "cpu"])  # -n is required to run


@pytest.mark.parametrize("kind", ["alsa", "pulse"])
def test_unavailable_real_output(files, monkeypatch, kind):
    """A real TTL output whose library is absent returns 1 before any
    capture starts."""
    tmp, nets, wav = files
    monkeypatch.setattr(alsa, "_load_alsa", lambda: None)
    monkeypatch.setattr(pulse, "_load_pulse", lambda: None)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port_monitor.main(["-n", nets[0], "-a", wav, "--duration", "0.2", "--device", "cpu",
                                "--output", kind])
    assert rc == 1 and f"Unable to open {kind} output" in err.getvalue()


@pytest.mark.parametrize("libs", [False, True], ids=["no-libs", "fake-libs"])
def test_list_devices(monkeypatch, libs):
    """``--list-devices`` registers the ALSA PCMs and PulseAudio devices the
    libraries report (none without them) and returns 0 either way."""
    monkeypatch.setattr(audio_io, "_registry", [])
    monkeypatch.setattr(alsa, "_registered_uids", set())
    monkeypatch.setattr(pulse, "_registered_uids", set())
    monkeypatch.setattr(alsa, "_load_alsa", (lambda: FakeAlsa()) if libs else (lambda: None))
    monkeypatch.setattr(pulse, "_load_pulse", (lambda: object()) if libs else (lambda: None))
    monkeypatch.setattr(pulse, "_load_pulse_async",
                        (lambda: PortFakePulseAsync()) if libs else (lambda: None))
    out = run(port_monitor.main, ["--list-devices"])
    if not libs:
        assert out == ["No audio devices registered (simulated sources only)."]
        return
    text = "\n".join(out)
    for uid in ("alsa:hw:CARD=Fake,DEV=0", "alsa:monitor:CARD=Fake", "pulse:alsa_input.usb1",
                "pulse:default-source", "pulse:default-sink"):
        assert f"[{uid}]" in text
    assert "Fake Soundcard" in text and "USB Audio CODEC" in text
    assert all(" in=" in line and " out=" in line for line in out)


def test_interactive_matches_jax(files):
    """One scripted session (load three rows, a bad load, start, table,
    stop, an unknown command, quit) through the port's interactive_loop and
    the JAX one: the same replies but the level table, the same detections
    per channel, and event logs equal in columns 1-3."""
    tmp, nets, wav = files
    script = [f"load {i} {n}" for i, n in enumerate(nets)] + [
        "load x y", "table", "start", "table", "stop", "stop", "frobnicate", "quit"]

    def session(loop, args):
        replies = []
        feed = iter(script)
        assert loop(args, input_fn=lambda _: next(feed), out=replies.append) == 0
        return replies

    port_log, jax_log = str(tmp / "iport.csv"), str(tmp / "ijax.csv")
    got = session(port_monitor.interactive_loop, port_monitor._build_parser().parse_args(
        ["--interactive", "-a", wav, "--duration", "1", "--device", "cpu", "--event-log", port_log]))
    want = session(jax_monitor.interactive_loop, argparse.Namespace(
        audio=wav, duration=1.0, realtime=False, event_log=jax_log))

    def shown(replies):  # the level rows' values depend on timing
        return [r for r in replies if not r.lstrip()[:1].isdigit()]

    assert shown(got) == shown(want)
    stopped = [r for r in got if r.startswith("stopped; detections per channel:")]
    assert len(stopped) == 1 and "not running" in got
    assert_same_events(port_log, jax_log, eval(stopped[0].split(":", 1)[1]))


@pytest.mark.parametrize(
    "kind,mode", [("alsa", ["--batched-drain", "--wire-format", "int16"]), ("pulse", [])],
    ids=["alsa-batched-int16", "pulse-per-lane"])
def test_capture_matches_sim(files, monkeypatch, kind, mode):
    """Real-capture input over a fake sound library that replays the WAV on
    every channel, with the TTL pulses on the same library's playback: the
    event log equals the simulated input's on the same samples, and every
    channel that detected got a pulse."""
    tmp, nets, wav = files
    audio = fixtures.chirp_audio(1.0, 31)
    fake = (fixtures.ReplayAlsa if kind == "alsa" else fixtures.ReplayPulse)(audio, 3)
    monkeypatch.setattr(alsa, "_load_alsa", lambda: fake)
    monkeypatch.setattr(pulse, "_load_pulse", lambda: fake)
    argv = [a for n in nets for a in ("-n", n)] + [
        "--channels", "3", "--duration", "1", "--refresh", "5", "--device", "cpu",
        "--frame-size", "2205", *mode]
    sim_log, cap_log = str(tmp / f"sim-{kind}.csv"), str(tmp / f"cap-{kind}.csv")
    want = detections(run(port_monitor.main, argv + ["-a", wav, "--event-log", sim_log]))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = detections(run(port_monitor.main, argv + [
            "-a", wav, "--input", kind, "--output", kind, "--event-log", cap_log]))
    assert "is ignored with --input" in err.getvalue()
    assert got == want and fake.delivered == len(audio)
    assert_same_events(cap_log, sim_log, got)
    assert [p > 0 for p in fake.pulses] == [c > 0 for c in got]
    assert all(p <= c for p, c in zip(fake.pulses, got))


def test_live_path_runs_with_jax_blocked(tmp_path):
    """The monitor, Processor and DetectorBank import, a 2-lane bank drains
    on the CPU, and the monitor runs batched on the int16 wire, from the
    simulated device and from ALSA capture (a replaying fake libasound), in
    a process where importing jax or the JAX package fails."""
    net, wav = str(tmp_path / "net.txt"), str(tmp_path / "in.wav")
    save_config(fixtures.sample_geometry_config(1), net)
    write_wav(wav, fixtures.chirp_audio(0.5, 3), fixtures.RATE, dtype="float32")
    script = (
        "import numpy as np\n"
        "import syllable_detector_tpu_torch.monitor as monitor\n"
        "import syllable_detector_tpu_torch.runtime.processor\n"
        "from syllable_detector_tpu_torch import fixtures\n"
        "from syllable_detector_tpu_torch.models.detector_bank import DetectorBank\n"
        "cfgs = [fixtures.sample_geometry_config(s) for s in (1, 2)]\n"
        "bank = DetectorBank(cfgs, device='cpu', transfer_dtype='int16')\n"
        "assert bank._stager is not None\n"
        "for lane in range(2):\n"
        "    bank.append_audio_data(lane, fixtures.chirp_audio(0.5, lane))\n"
        "out = bank.drain()\n"
        "assert out.shape[0] == 2 and bank.last_counts.min() > 100, out.shape\n"
        f"rc = monitor.main(['-n', {net!r}, '-a', {wav!r}, '--channels', '2',\n"
        "                   '--duration', '0.5', '--refresh', '5', '--batched-drain',\n"
        "                   '--wire-format', 'int16', '--device', 'cpu'])\n"
        "assert rc == 0\n"
    )
    proc = blocked_run(script)
    assert proc.returncode == 0, proc.stderr
    assert "detections per channel:" in proc.stdout
