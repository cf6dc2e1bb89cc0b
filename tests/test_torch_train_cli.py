"""The port's training loop (checkpoint, resume, chunking) and train CLI on
the CPU, against the JAX trainer and ``train.main``.

Resume is held bit for bit against an uninterrupted run of the port
itself, as the JAX package holds its own. Checkpoint side files (the
fingerprint and the rng sidecars) are NumPy-side and must have the JAX
trainer's content. The CLI must give the JAX CLI's return codes and stderr
texts, and a full ``--device cpu`` run must give a net whose detections
fall inside the labeled syllables (more than 80 % within 0.1 s), as the JAX
package's ``test_train_cli`` asks of its own.
"""

import contextlib
import dataclasses
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

import syllable_detector_tpu.train as jtrain
from syllable_detector_tpu.training import trainer as jt
from syllable_detector_tpu.utils.synth import make_labeled_audio
from syllable_detector_tpu.utils.wav import write_wav
from syllable_detector_tpu_torch import train as ptrain
from syllable_detector_tpu_torch.cli import main as cli_main
from syllable_detector_tpu_torch.config.model_format import load_config
from syllable_detector_tpu_torch.parallel.mesh import make_mesh
from syllable_detector_tpu_torch.training import trainer as pt

torch.set_num_threads(1)

SMALL = dict(batch_size=16, hidden=(2,), learning_rate=3e-3, seed=1)


def toy(seed, n=48, settings=None):
    settings = settings or pt.TrainSettings()
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, settings.n_features)).astype(np.float32)
    return feats, (feats[:, seed % 3] > 0).astype(np.float32)


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in leaves(tree[k])]
    return [a for v in tree for a in leaves(v)]


def assert_bit_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def run_single(s, feats, labels, **kw):
    return pt.train(s, feats, labels, device="cpu", **kw)


def run_ensemble(s, feats, labels, **kw):
    fl, ll = [feats, feats[:40]], [labels, labels[:40]]
    return pt.train_ensemble(s, fl, ll, device="cpu", **kw)


def run_mesh(s, feats, labels, **kw):
    return pt.train(s, feats, labels, mesh=make_mesh(4, axis="data", devices=["cpu"]), **kw)


RUNS = {"single": run_single, "ensemble": run_ensemble, "mesh": run_mesh}


@pytest.mark.parametrize("mode", list(RUNS))
def test_resume_bit_exact(mode, tmp_path):
    """An interrupted checkpointed run (4 of 6 epochs, a checkpoint every
    2) resumes and ends bit for bit equal to an uninterrupted run: params,
    Adam state (count per init as an int32 tensor) and thresholds."""
    run = RUNS[mode]
    feats, labels = toy(2, 60)
    s6 = pt.TrainSettings(epochs=6, n_init=2, **SMALL)
    s4 = dataclasses.replace(s6, epochs=4)
    _, full, t_full = run(s6, feats, labels)
    d = str(tmp_path / "ckpt")
    run(s4, feats, labels, checkpoint_dir=d, checkpoint_every=2)
    assert sorted(os.listdir(d)) == [
        "fingerprint.json", "rng_00000002.json", "rng_00000004.json",
        "step_00000002", "step_00000004"]
    _, resumed, t_res = run(s6, feats, labels, checkpoint_dir=d, checkpoint_every=2)
    assert_bit_equal(resumed, full)
    assert t_res == t_full
    from syllable_detector_tpu_torch.training.checkpoint import restore_checkpoint

    count = restore_checkpoint(d, 6)["opt_state"][0]
    # 6 epochs of 3 steps (60 rows, or the longest channel's, in batches of 16)
    assert count.dtype == torch.int32 and set(count.tolist()) == {18}


def test_side_files_match_jax(tmp_path):
    """The fingerprint and the rng sidecars are the JAX trainer's, byte for
    byte in content: both are NumPy-side."""
    feats, labels = toy(4, 40)
    kw = dict(epochs=2, n_init=1, **SMALL)
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jt.train(jt.TrainSettings(**kw), feats, labels, checkpoint_dir=str(jd), checkpoint_every=1)
    pt.train(pt.TrainSettings(**kw), feats, labels, checkpoint_dir=str(pd), checkpoint_every=1,
             device="cpu")
    for name in ("fingerprint.json", "rng_00000001.json", "rng_00000002.json"):
        assert json.loads((pd / name).read_text()) == json.loads((jd / name).read_text()), name


MISMATCHES = {
    "seed": lambda s, f, l: (dataclasses.replace(s, seed=s.seed + 1), f, l),
    "data": lambda s, f, l: (s, f * 2.0, l),
    "labels": lambda s, f, l: (s, f, 1.0 - l),
    "row order": lambda s, f, l: (s, f[np.random.default_rng(0).permutation(len(f))],
                                  l[np.random.default_rng(0).permutation(len(f))]),
}


@pytest.mark.parametrize("kind", [*MISMATCHES, "ensemble", "epochs"])
def test_checkpoint_guards(kind, tmp_path):
    """A checkpoint directory resumes only the run that made it; shrinking
    epochs below its checkpoint is an error, extending them resumes."""
    feats, labels = toy(7, 30)
    s = pt.TrainSettings(epochs=2, n_init=1, **{**SMALL, "batch_size": 8})
    d = str(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="checkpoint_every"):
        run_single(s, feats, labels, checkpoint_dir=d, checkpoint_every=0)
    run_single(s, feats, labels, checkpoint_dir=d, checkpoint_every=1)
    if kind == "ensemble":
        with pytest.raises(ValueError, match="different training run"):
            pt.train_ensemble(s, [feats], [labels], checkpoint_dir=d, checkpoint_every=1,
                              device="cpu")
    elif kind == "epochs":
        with pytest.raises(ValueError, match="beyond"):
            run_single(dataclasses.replace(s, epochs=1), feats, labels, checkpoint_dir=d,
                       checkpoint_every=1)
        run_single(dataclasses.replace(s, epochs=4), feats, labels, checkpoint_dir=d,
                   checkpoint_every=1)
        assert sorted(glob.glob(os.path.join(d, "step_*")))[-1].endswith("step_00000004")
    else:
        with pytest.raises(ValueError, match="different training run"):
            run_single(*MISMATCHES[kind](s, feats, labels), checkpoint_dir=d,
                       checkpoint_every=1)


def test_corrupt_side_files(tmp_path):
    """A truncated fingerprint raises naming the directory (the JAX text);
    a corrupt rng sidecar leaves the generator untouched and returns False,
    so resume falls back to draw-and-discard."""
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "fingerprint.json").write_text('{"epochs": 5, "tr')
    with pytest.raises(ValueError) as got:
        pt._check_fingerprint(str(d), {"epochs": 5})
    with pytest.raises(ValueError) as want:
        jt._check_fingerprint(str(d), {"epochs": 5})
    assert str(got.value) == str(want.value) and "unreadable fingerprint" in str(got.value)
    (d / "rng_00000004.json").write_text("[{broken")
    rng = np.random.default_rng(7)
    before = rng.bit_generator.state
    assert not pt._restore_rng_state(str(d), 4, [rng])
    assert rng.bit_generator.state == before


def test_rng_sidecar_and_fallback_bit_exact(tmp_path):
    """Resume restores the epoch rng from its sidecar (the state after the
    completed epochs, O(1)); with the sidecars deleted it fast-forwards.
    Both end bit for bit equal to the uninterrupted run."""
    feats, labels = toy(11, 48)
    s6 = pt.TrainSettings(epochs=6, n_init=1, **SMALL)
    s4 = dataclasses.replace(s6, epochs=4)
    _, full, _ = run_single(s6, feats, labels)
    for delete in (False, True):
        d = tmp_path / f"ckpt{delete}"
        run_single(s4, feats, labels, checkpoint_dir=str(d), checkpoint_every=2)
        if delete:
            for f in glob.glob(str(d / "rng_*.json")):
                os.remove(f)
        else:
            fresh, oracle = np.random.default_rng(s6.seed), np.random.default_rng(s6.seed)
            for _ in range(4):
                oracle.permutation(len(feats))
            assert pt._restore_rng_state(str(d), 4, [fresh])
            assert fresh.bit_generator.state == oracle.bit_generator.state
        _, resumed, _ = run_single(s6, feats, labels, checkpoint_dir=str(d), checkpoint_every=2)
        assert_bit_equal(resumed, full)


@pytest.mark.parametrize("mode", ["single", "ensemble"])
@pytest.mark.parametrize("variant", ["index budget", "verbose"])
def test_chunking_is_bit_exact(mode, variant, monkeypatch):
    """One upload for the whole run, one epoch per call under a 1-byte index
    budget, and verbose runs (one epoch per call, printed) all give the same
    bits."""
    feats, labels = toy(9, 40)
    s = pt.TrainSettings(epochs=5, n_init=2, **SMALL)
    run = RUNS[mode]
    _, whole, t_whole = run(s, feats, labels)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if variant == "index budget":
            monkeypatch.setattr(pt, "_INDEX_BUDGET_BYTES", 1)
            _, chunked, t_chunked = run(s, feats, labels)
        else:
            _, chunked, t_chunked = run(s, feats, labels, verbose=True)
    assert_bit_equal(chunked, whole)
    assert t_chunked == t_whole
    if variant == "verbose":
        lines = out.getvalue().splitlines()
        assert [l.split(":")[0] for l in lines] == ["epoch 0", "epoch 4"]
        assert lines[0].endswith("(best of 2 inits)")


def test_ensemble_epoch_covers_longest_channel(monkeypatch):
    """An epoch covers the LONGEST channel (shorter ones wrap, every index
    within its channel's length); quiet runs upload the whole [E*S, C, bs]
    index tensor once, verbose runs one epoch at a time."""
    s = pt.TrainSettings(epochs=2, batch_size=8, n_init=1, hidden=(2,))
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((n, s.n_features)).astype(np.float32) for n in (10, 40)]
    labels = [(rng.random(n) > 0.5).astype(np.float32) for n in (10, 40)]
    seen = []
    real = pt.make_ensemble_epoch

    def counting(*a, **kw):
        epoch = real(*a, **kw)

        def wrapped(params, opt_state, feats_all, labs_all, idx):
            seen.append(tuple(idx.shape))
            assert idx.dtype == torch.int32
            assert idx[:, 0].max() < 10 and idx[:, 1].max() < 40
            return epoch(params, opt_state, feats_all, labs_all, idx)

        return wrapped

    monkeypatch.setattr(pt, "make_ensemble_epoch", counting)
    pt.train_ensemble(s, feats, labels, device="cpu")
    assert seen == [(10, 2, 8)]
    seen.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        pt.train_ensemble(s, feats, labels, verbose=True, device="cpu")
    assert seen == [(5, 2, 8), (5, 2, 8)]


@pytest.mark.parametrize("case", ["no rows", "empty channel", "mesh too big", "columns"])
def test_input_validation_matches_jax(case):
    """Degenerate inputs raise the JAX trainer's ValueError texts."""
    from syllable_detector_tpu.parallel.mesh import make_mesh as jmesh

    kw = dict(epochs=1, **SMALL)
    s = pt.TrainSettings(**kw)
    empty = np.zeros((0, s.n_features), np.float32)
    four = (np.zeros((4, s.n_features), np.float32), np.zeros(4, np.float32))
    calls = {
        "no rows": lambda m, mesh: m.train(m.TrainSettings(**kw), empty, np.zeros(0, np.float32),
                                           **({"device": "cpu"} if m is pt else {})),
        "empty channel": lambda m, mesh: m.train_ensemble(
            m.TrainSettings(**kw), [four[0], empty], [four[1], np.zeros(0, np.float32)]),
        "mesh too big": lambda m, mesh: m.train(
            m.TrainSettings(**kw), np.zeros((3, s.n_features), np.float32),
            np.zeros(3, np.float32), mesh=mesh),
        "columns": lambda m, mesh: m.train_ensemble(
            m.TrainSettings(**kw), [np.zeros((4, 7), np.float32)], [four[1]],
            **({"device": "cpu"} if m is pt else {})),
    }
    with pytest.raises(ValueError) as want:
        calls[case](jt, jmesh(4, axis="data"))
    with pytest.raises(ValueError) as got:
        calls[case](pt, make_mesh(4, axis="data", devices=["cpu"]))
    assert str(got.value) == str(want.value)


def run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    audio, intervals = make_labeled_audio(seconds=3.0)
    wav, lab = d / "train.wav", d / "labels.csv"
    write_wav(wav, audio, 44100, dtype="float32")
    lab.write_text("# start,end\n" + "\n".join(f"{lo},{hi}" for lo, hi in intervals))
    empty = d / "empty.csv"
    empty.write_text("# nothing\n")
    return d, str(wav), str(lab), intervals, str(empty)


def cli_cases(wav, lab, empty, d):
    return {
        "mismatched pairs": ["-a", wav, "-a", wav, "-l", lab, "-o", f"{d}/x.txt"],
        "bad input processing": ["-a", wav, "-l", lab, "-o", f"{d}/x.txt", "--epochs", "1",
                                 "--quiet", "--input-processing", "mapcube"],
        "channel-parallel single": ["-a", wav, "-l", lab, "-o", f"{d}/x.txt",
                                    "--channel-parallel"],
        "data-parallel multi": ["-a", wav, "-l", lab, "-a", wav, "-l", lab, "-o",
                                f"{d}/x.txt", "--data-parallel"],
        "missing audio": ["-a", f"{d}/none.wav", "-l", lab, "-o", f"{d}/x.txt"],
        "no intervals": ["-a", wav, "-l", empty, "-o", f"{d}/x.txt"],
        "no channel": ["-a", wav, "-l", lab, "-o", f"{d}/x.txt", "--channel", "3"],
        "bad fft": ["-a", wav, "-l", lab, "-o", f"{d}/x.txt", "--fft", "300"],
    }


@pytest.mark.parametrize("case", list(cli_cases("w", "l", "e", "d")))
def test_cli_errors_match_jax(labeled, case):
    """Return code 1 and the JAX CLI's stderr text, word for word."""
    d, wav, lab, _, empty = labeled
    argv = cli_cases(wav, lab, empty, d)[case]
    jrc, _, jerr = run_main(jtrain.main, argv)
    rc, _, err = run_main(ptrain.main, argv + ["--device", "cpu"])
    assert rc == jrc == 1
    assert err == jerr and err
    assert not os.path.exists(f"{d}/x.txt")


def test_cli_single_pair_ch_template(labeled, tmp_path):
    """A {ch} template with one pair writes channel 0's file, as in JAX."""
    _, wav, lab, _, _ = labeled
    out = tmp_path / "net_{ch}.txt"
    rc, stdout, _ = run_main(ptrain.main, ["-a", wav, "-l", lab, "-o", str(out), "--epochs",
                                           "3", "--quiet", "--device", "cpu"])
    assert rc == 0 and not stdout
    assert (tmp_path / "net_0.txt").exists() and not (tmp_path / "net_{ch}.txt").exists()
    assert ptrain._channel_output_path("a/net.txt", 3) == jtrain._channel_output_path("a/net.txt", 3)
    assert ptrain.read_labels(lab) == jtrain.read_labels(lab)


def test_cli_trains_a_detecting_net(labeled, tmp_path):
    """Full loop on the CPU: WAV + label CSV -> ``train.main --device cpu``
    -> net file -> the port's CLI; more than 80 % of the detections fall
    within 0.1 s of a labeled interval. The verbose lines have the JAX
    CLI's form."""
    _, wav, lab, intervals, _ = labeled
    net = tmp_path / "net.txt"
    rc, stdout, _ = run_main(ptrain.main, ["-a", wav, "-l", lab, "-o", str(net), "--epochs",
                                           "150", "--device", "cpu"])
    assert rc == 0 and net.exists()
    lines = stdout.splitlines()
    assert lines[0].startswith(f"{wav}: ") and "290 features" in lines[0]
    assert lines[1].startswith("epoch 0: loss ") and lines[-1].endswith(f"wrote {net}")
    assert load_config(net).layers[0].weights.shape == (4, 290)
    rc, csv, _ = run_main(cli_main, ["-n", str(net), "-a", wav, "--device", "cpu"])
    detections = [l for l in csv.splitlines() if l]
    assert rc == 0 and detections
    hits = sum(any(lo - 0.1 <= float(l.split(",")[2]) <= hi + 0.1 for lo, hi in intervals)
               for l in detections)
    assert hits / len(detections) > 0.8, (hits, len(detections))


def test_cli_ensemble_channel_parallel(tmp_path):
    """Two pairs train two nets through ``--channel-parallel`` (one CPU
    shard with ``--device cpu``), each exported under the {ch} template
    and equal to the unsharded ensemble's."""
    argv = []
    for i, seed in enumerate((3, 9)):
        audio, intervals = make_labeled_audio(seconds=2.0, seed=seed)
        write_wav(tmp_path / f"a{i}.wav", audio, 44100, dtype="float32")
        (tmp_path / f"l{i}.csv").write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
        argv += ["-a", str(tmp_path / f"a{i}.wav"), "-l", str(tmp_path / f"l{i}.csv")]
    base = argv + ["--epochs", "5", "--device", "cpu"]
    assert run_main(ptrain.main, base + ["--quiet", "-o", str(tmp_path / "net_{ch}.txt")])[0] == 0
    rc, stdout, _ = run_main(
        ptrain.main, base + ["-o", str(tmp_path / "mesh.txt"), "--channel-parallel"])
    assert rc == 0 and stdout.splitlines()[-1].startswith("channel 1: threshold ")
    for c in range(2):
        assert (tmp_path / f"net_{c}.txt").read_text() == (tmp_path / f"mesh_{c}.txt").read_text()


def test_cuda_without_card_raises(labeled):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, wav, lab, _, _ = labeled
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.main(["-a", wav, "-l", lab, "-o", "x.txt"])
