"""The port's live monitor against the JAX package's, and the live path's
independence from JAX.

Both monitors stream the same WAV through 3 channels with 3 distinct nets
and write an event log. The "detections per channel:" line must match, and
the sorted event logs must be identical in columns 1-3 (outputs within
rtol=1e-3, atol=2e-4). TTL event counts are not compared: they depend on
how the worker coalesces drain rounds.
"""

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
from test_torch_cli import blocked_run

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


def test_live_path_runs_with_jax_blocked(tmp_path):
    """The monitor, Processor and DetectorBank import, a 2-lane bank drains
    on the CPU, and the monitor runs batched on the int16 wire, in a process
    where importing jax or the JAX package fails."""
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
