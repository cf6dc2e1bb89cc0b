"""The port's copies of the framework-free host modules against the JAX
package's originals: the net file format, audio ingest, CSV number
formatting, running statistics, the native ring buffer and the drain
stager. The copies must behave identically; the classes are the port's
own, so no test passes an object of one package to the other's isinstance.
"""

import dataclasses
import os
import threading
import warnings

import numpy as np
import pytest

from syllable_detector_tpu.config import model_format as jmf
from syllable_detector_tpu.runtime import ring_buffer as jring
from syllable_detector_tpu.utils import fmt as jfmt
from syllable_detector_tpu.utils import stats as jstats
from syllable_detector_tpu.utils import wav as jwav
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.config import model_format as tmf
from syllable_detector_tpu_torch.models.detector_bank import _mulaw_lut
from syllable_detector_tpu_torch.runtime import ring_buffer as tring
from syllable_detector_tpu_torch.utils import fmt as tfmt
from syllable_detector_tpu_torch.utils import native_build
from syllable_detector_tpu_torch.utils import stats as tstats
from syllable_detector_tpu_torch.utils import wav as twav
from syllable_detector_tpu_torch.utils.timing import Time

CONFIGS = {
    "sample": lambda: fixtures.sample_geometry_config(0),
    "deep-log": lambda: fixtures.sample_geometry_config(
        3, hidden=(8, 6), transfers=("LogSig", "SatLin", "PureLin"), scaling="log"
    ),
    "gap": fixtures.gap_config,
}


def fields(cfg):
    """A config's fields as plain Python and numpy values, nested."""
    return {
        f.name: (
            [fields(v) if dataclasses.is_dataclass(v) else v for v in value]
            if isinstance(value, list)
            else value
        )
        for f in dataclasses.fields(cfg)
        for value in [getattr(cfg, f.name)]
    }


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_load_and_save_match_jax(name, tmp_path):
    cfg = CONFIGS[name]()
    path = tmp_path / "net.txt"
    jmf.save_config(cfg, path)
    got, want = tmf.load_config(path), jmf.load_config(path)
    assert type(got) is tmf.SyllableDetectorConfig and type(want) is jmf.SyllableDetectorConfig
    assert_same(fields(got), fields(want))
    assert got.first_output_sample == want.first_output_sample
    # both writers give the same text, for a config of either package
    mine = tmp_path / "mine.txt"
    tmf.save_config(got, mine)
    assert mine.read_text() == path.read_text()
    assert tmf.dumps_config(want) == jmf.dumps_config(got) == path.read_text()
    assert_same(fields(tmf.loads_config(path.read_text())), fields(want))


def test_config_errors_match_jax():
    text = jmf.dumps_config(fixtures.sample_geometry_config(0))
    for broken in (text.replace("fourierLength = 256", "fourierLength = abc"), "samplingRate = 44100\n"):
        with pytest.raises(jmf.ConfigError) as jerr:
            jmf.loads_config(broken)
        with pytest.raises(tmf.ConfigError) as terr:
            tmf.loads_config(broken)
        assert str(terr.value) == str(jerr.value)


def _write_stdlib(path, module, pcm, channels, rate, comptype=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mod = __import__(module)
    f = mod.open(str(path), "wb")
    f.setnchannels(channels)
    f.setsampwidth(2)
    f.setframerate(rate)
    if comptype:
        f.setcomptype(comptype, "")
    f.writeframes(pcm.tobytes())
    f.close()


def test_read_wav_reads_a_pipe_as_jax_reads_the_file(tmp_path):
    """``read_wav`` walks a WAV it cannot seek in, a pipe, in memory: the
    samples and rate the JAX package reads from the same bytes in a file."""
    x = (np.random.default_rng(5).standard_normal((700, 2)) * 0.3).astype(np.float32)
    path, pipe = tmp_path / "a.wav", tmp_path / "pipe"
    jwav.write_wav(path, x, 48000, dtype="int16")
    os.mkfifo(pipe)
    writer = threading.Thread(target=lambda: pipe.write_bytes(path.read_bytes()), daemon=True)
    writer.start()
    got, rate = twav.read_wav(pipe)
    writer.join(timeout=30)
    want, jrate = jwav.read_wav(path)
    assert rate == jrate == 48000 and got.shape == want.shape == (700, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["wav-int16", "wav-float32", "aiff", "au", "au-ulaw"])
def test_read_audio_matches_jax(kind, tmp_path):
    x = (np.random.default_rng(4).standard_normal((700, 2)) * 0.3).astype(np.float32)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype(">i2")
    path = tmp_path / f"a.{kind}"
    if kind.startswith("wav"):
        jwav.write_wav(path, x, 48000, dtype=kind[4:])
    elif kind == "aiff":
        _write_stdlib(path, "aifc", pcm, 2, 22050)
    elif kind == "au":
        _write_stdlib(path, "sunau", pcm[:, 0], 1, 8000, "NONE")
    else:
        _write_stdlib(path, "sunau", pcm[:, 0].astype("=i2"), 1, 8000, "ULAW")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got, rate = twav.read_audio(path)
        want, jrate = jwav.read_audio(path)
    assert rate == jrate and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and len(got) == 700
    np.testing.assert_array_equal(got, want)
    # and the port's writer writes the JAX writer's bytes
    mine = tmp_path / "mine.wav"
    twav.write_wav(mine, got, rate, dtype="float32")
    jwav.write_wav(tmp_path / "theirs.wav", want, jrate, dtype="float32")
    assert mine.read_bytes() == (tmp_path / "theirs.wav").read_bytes()


def test_fmt_matches_jax():
    rng = np.random.default_rng(9)
    values = np.concatenate([
        rng.standard_normal(200) * 10.0 ** rng.integers(-8, 8, 200),
        [0.0, -0.0, 1.0, 36.1292063492063, 1e-300, 1e300, np.nan, np.inf, -np.inf],
    ])
    for v in values:
        assert tfmt.fmt_double(v) == jfmt.fmt_double(v)
        with np.errstate(over="ignore"):
            f = np.float32(v)
        assert tfmt.fmt_float32(f) == jfmt.fmt_float32(f)


def test_stats_and_timing_match_jax():
    rng = np.random.default_rng(2)
    for name in ("StatMean", "StatMax"):
        mine = tstats.SummaryStat(getattr(tstats, name)())
        theirs = jstats.SummaryStat(getattr(jstats, name)())
        for chunk in np.split(rng.standard_normal(60), 6):
            for v in chunk:
                mine.write_value(float(v))
                theirs.write_value(float(v))
            assert mine.read_stat_and_reset() == theirs.read_stat_and_reset()
        assert mine.read_stat_and_reset() == theirs.read_stat_and_reset() is None
    Time.reset()
    for ns in (5, 1, 9):
        Time.save_with_name("t", ns)
    assert Time.summaries()["t"]["count"] == 3 and Time.summaries()["t"]["max_ns"] == 9.0
    Time.reset()


@pytest.mark.parametrize("force_python", [False, True], ids=["native", "python"])
def test_ring_buffer_round_trip(force_python):
    ring = tring.RingBuffer(1000, force_python=force_python)
    theirs = jring.RingBuffer(1000, force_python=force_python)
    assert ring.capacity == theirs.capacity
    rng = np.random.default_rng(8)
    sent, got = [], []
    for _ in range(40):  # wraps the ring several times
        block = rng.standard_normal(int(rng.integers(1, 300))).astype(np.float32)
        ok = ring.produce(block)
        assert ok == theirs.produce(block)
        if ok:
            sent.append(block)
        k = int(rng.integers(0, ring.fill + 1))
        out = ring.peek(k).copy()
        np.testing.assert_array_equal(out, theirs.peek(k))
        ring.consume(len(out))
        theirs.consume(len(out))
        got.append(out)
        assert ring.fill == theirs.fill
    got.append(ring.peek().copy())
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(sent))
    ring.clear()
    assert ring.fill == 0


def test_ring_block_writer_matches_jax():
    rings = [tring.RingBuffer(512) for _ in range(3)]
    theirs = [jring.RingBuffer(512) for _ in range(3)]
    mine_w, their_w = tring.RingBlockWriter(rings), jring.RingBlockWriter(theirs)
    rng = np.random.default_rng(12)
    for _ in range(8):
        block = rng.standard_normal((3, int(rng.integers(1, 200)))).astype(np.float32)
        np.testing.assert_array_equal(mine_w.produce(block), their_w.produce(block))
        for r, t in zip(rings, theirs):
            np.testing.assert_array_equal(r.peek(), t.peek())


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_drain_stager_matches_jax(wire):
    """One seeded drain round through both native stagers: the same staged
    rows, the same zeroed stale tails, the same fill watermarks."""
    lanes, need = 5, 300
    mine, theirs = tring.DrainStager(lanes), jring.DrainStager(lanes)
    assert mine.available and theirs.available
    dtype = {"float32": np.float32, "int16": np.int16, "mulaw8": np.int8}[wire]
    rng = np.random.default_rng(13)
    xs = [np.full((lanes, need), 7, dtype) for _ in range(2)]
    prev = [np.full(lanes, need, np.int64) for _ in range(2)]
    lut = _mulaw_lut()
    for _ in range(3):
        rows = [
            None if lane == 2 else rng.uniform(-1.2, 1.2, int(rng.integers(0, need + 1))).astype(np.float32)
            for lane in range(lanes)
        ]
        for stager, x, p in ((mine, xs[0], prev[0]), (theirs, xs[1], prev[1])):
            for i, data in enumerate(rows):
                stager.lens[i] = 0 if data is None else len(data)
                if data is not None:
                    stager.ptrs[i] = data.ctypes.data
            mode = stager.MODES[wire]
            stager.stage(x, p, mode, lut.ctypes.data if mode == 2 else 0, keepalive=rows)
        np.testing.assert_array_equal(xs[0], xs[1])
        np.testing.assert_array_equal(prev[0], prev[1])
    assert (xs[0][2] == 0).all()  # a lane with no data keeps a zeroed row


def test_native_libraries_build_apart():
    """The port's native ring library is built from the repository's
    native/ sources into build/native/, never the JAX package's copy."""
    assert tring.native_available()
    assert tring._LIB_PATH.startswith(native_build.NATIVE_BUILD)
    assert tring._LIB_PATH != jring._LIB_PATH
    assert native_build.NATIVE_SRC == jring._NATIVE_DIR.rstrip("/")
