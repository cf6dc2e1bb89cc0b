"""The port's CLI end to end on the CPU: its CSV against the JAX CLI's and
the NumPy oracle's, its error paths, and its independence from JAX.

Columns 1-3 (channel, sample, seconds) must match exactly and outputs
within rtol=1e-4, atol=1e-5, the contract of tests/test_cli_golden.py.
Thresholds sit at least 1e-3 from every output of the fixture audio, so no
decision can flip between implementations that agree within tolerance.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import reference_impl as ref
import syllable_detector_tpu.cli as jax_cli
from syllable_detector_tpu.config.model_format import save_config
from syllable_detector_tpu.utils.wav import write_wav
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.cli import main as port_main
from syllable_detector_tpu_torch.ops.resample import polyphase_resample
from syllable_detector_tpu_torch.runtime.track_detector import TrackDetector

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "syllable_detector_tpu_torch"


def assert_csv_close(got, want, rtol=1e-4, atol=1e-5):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        gp, wp = g.split(","), w.split(",")
        assert gp[:3] == wp[:3], (g, w)
        np.testing.assert_allclose(
            [float(v) for v in gp[3:]], [float(v) for v in wp[3:]],
            rtol=rtol, atol=atol,
        )


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    two = np.stack([fixtures.chirp_audio(0.8, 1), fixtures.chirp_audio(0.8, 2)], 1)
    one = fixtures.chirp_audio(0.5, 3)
    # "slow" plays "one" at 22.05 kHz: the net hears it resampled
    heard = polyphase_resample(one, 22050, 44100, device="cpu").numpy()
    cfg = fixtures.pick_thresholds(
        fixtures.sample_geometry_config(7), np.concatenate([two.reshape(-1), one, heard])
    )
    paths = {
        "net": d / "net.txt",
        "net2": d / "net2.txt",
        "gap_net": d / "gap.txt",
        "two": d / "two.wav",
        "one": d / "one.wav",
        "slow": d / "slow.wav",
    }
    save_config(cfg, paths["net"])
    save_config(
        fixtures.pick_thresholds(fixtures.sample_geometry_config(8), two), paths["net2"]
    )
    save_config(fixtures.gap_config(), paths["gap_net"])
    write_wav(paths["two"], two, 44100, dtype="float32")
    write_wav(paths["one"], one, 44100, dtype="float32")
    write_wav(paths["slow"], one, 22050, dtype="float32")
    return cfg, two, {k: str(v) for k, v in paths.items()}


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def run_jax(argv, monkeypatch):
    # the JAX CLI would also set up a compile cache under $HOME
    monkeypatch.setattr(jax_cli, "_enable_persistent_compile_cache", lambda: None)
    return run(jax_cli.main, argv)


def split_files(lines, paths):
    """{path: detection lines} from a multi-file CSV."""
    out, cur = {}, None
    for line in lines:
        if line in paths:
            cur = out.setdefault(line, [])
        else:
            cur.append(line)
    return out


@pytest.mark.parametrize("method", ["matmul", "fused", "rfft"])
def test_csv_matches_jax_cli(files, method, monkeypatch):
    _, _, p = files
    argv = ["-n", p["net"], "-a", p["two"], "-a", p["one"], "-d", "0.05"]
    rc, got, _ = run(port_main, argv + ["--method", method, "--device", "cpu"])
    jrc, want, _ = run_jax(argv, monkeypatch)
    assert rc == jrc == 0
    got_f = split_files(got, [p["two"], p["one"]])
    want_f = split_files(want, [p["two"], p["one"]])
    assert list(got_f) == list(want_f) == [p["two"], p["one"]]
    for path in got_f:
        assert got_f[path], "fixture audio must trigger detections"
        assert_csv_close(got_f[path], want_f[path])
    assert {line.split(",")[0] for line in got_f[p["two"]]} == {"0", "1"}


def test_track_detector_matches_oracle(files):
    cfg, two, _ = files
    x = two[:, 0]
    got = []
    td = TrackDetector(cfg, channel=0, emit=got.append, method="fused", device="cpu")
    td.debounce_time = 0.05
    for start in range(0, len(x), 7000):
        td.process(x[start : start + 7000])
    want = ref.cli_lines(cfg, x, 0, debounce_frames=int(0.05 * 44100))
    assert 0 < len(want) < len(ref.cli_lines(cfg, x, 0))
    assert_csv_close(got, want)


def test_repeated_nets_cycle_per_channel(files, monkeypatch):
    _, _, p = files
    argv = ["-n", p["net"], "-n", p["net2"], "-a", p["two"]]
    rc, got, _ = run(port_main, argv + ["--device", "cpu"])
    jrc, want, _ = run_jax(argv, monkeypatch)
    assert rc == jrc == 0
    assert_csv_close(got, want)
    rc, got, err = run(port_main, ["-n", p["net"], "-n", p["gap_net"], "-a", p["two"], "--device", "cpu"])
    assert rc == 1 and not got and "does not share" in err


def test_rate_mismatch_is_skipped_unless_asked(files, monkeypatch):
    """A file at another rate than the net's is resampled, as the JAX CLI
    resamples it, unless --no-resample asks to process it at the net's
    rate."""
    _, _, p = files
    argv = ["-n", p["net"], "-a", p["slow"]]
    rc, got, err = run(port_main, argv + ["--device", "cpu"])
    jrc, want, jerr = run_jax(argv, monkeypatch)
    assert rc == jrc == 0 and err == jerr and err.startswith("Resampling ")
    assert got
    assert_csv_close(got, want)
    argv = ["-n", p["net"], "-a", p["slow"], "--no-resample"]
    rc, got, err = run(port_main, argv + ["--device", "cpu"])
    jrc, want, jerr = run_jax(argv, monkeypatch)
    assert "Warning" in err and err == jerr
    assert_csv_close(got, want)


def test_bad_inputs_report_and_continue(files, tmp_path):
    _, _, p = files
    bad_net = tmp_path / "bad.txt"
    bad_net.write_text("samplingRate = 44100\n")
    rc, got, err = run(port_main, ["-n", str(bad_net), "-a", p["one"], "--device", "cpu"])
    assert rc == 1 and "Unable to load" in err
    missing = str(tmp_path / "missing.wav")
    rc, got, err = run(port_main, ["-n", p["net"], "-a", missing, "-a", p["one"], "--device", "cpu"])
    assert rc == 0 and "Unable to read" in err
    assert got[0] == missing and got[1] == p["one"] and len(got) > 2


def test_cuda_without_card_raises(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, p = files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["-n", p["net"], "-a", p["one"]])


def blocked_run(script: str) -> subprocess.CompletedProcess:
    """Run ``script`` in a fresh interpreter where importing jax or any
    part of the JAX package fails; the script ends by asserting that no
    module of either got loaded."""
    prelude = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['syllable_detector_tpu'] = None\n"
    )
    check = (
        "bad = [m for m, mod in sys.modules.items() if mod is not None and (\n"
        "       m.split('.')[0] in ('jax', 'jaxlib', 'syllable_detector_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-c", prelude + script + check], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_runs_with_jax_blocked(files):
    """Every module of the port imports, and its CLI runs (fused, on a
    resampled file, batched), in a process where importing jax or the JAX
    package fails."""
    _, _, p = files
    runs = [
        ["-n", p["net"], "-a", p["two"], "--method", "fused"],
        ["-n", p["net"], "-a", p["slow"], "--method", "fused"],
        ["-n", p["net"], "-a", p["two"], "-a", p["slow"], "--batched", "--method", "fused"],
    ]
    script = (
        "import importlib, pkgutil\n"
        "import syllable_detector_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from syllable_detector_tpu_torch.cli import main\n"
        f"for argv in {runs!r}:\n"
        "    print('run')\n"
        "    assert main(argv + ['--device', 'cpu']) == 0\n"
    )
    proc = blocked_run(script)
    assert proc.returncode == 0, proc.stderr
    want = []
    for argv in runs:
        want += ["run"] + run(port_main, argv + ["--device", "cpu"])[1]
    assert proc.stdout.splitlines() == want and len(want) > 20


def test_source_never_imports_jax():
    """No module of the port, and not chip_smoke.py, imports jax or any
    part of the JAX package, or loads a file by its path."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|syllable_detector_tpu)\b"
        r"|import_module\(\s*['\"](jax|syllable_detector_tpu)\b"
        r"|spec_from_file_location",
        re.M,
    )
    for ok in ("from syllable_detector_tpu_torch.ops import stft", "import syllable_detector_tpu_torch"):
        assert not pattern.search(ok)
    for bad in ("import jax.numpy as jnp", "from syllable_detector_tpu.config import x",
                "import syllable_detector_tpu", "    from syllable_detector_tpu import cli"):
        assert pattern.search(bad), bad
    sources = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    hits = [
        f"{src}: {m.group(0).strip()}"
        for src in sources
        for m in pattern.finditer(src.read_text())
    ]
    assert not hits, hits
