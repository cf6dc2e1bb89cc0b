"""The port's trainer against the JAX trainer on the CPU.

The same seeded inputs go through ``syllable_detector_tpu.training.trainer``
and ``syllable_detector_tpu_torch.training.trainer``. ``jax.random`` draws
cannot be redrawn in torch, so the weight inits (and, for step-level
parity, the optimizer state) are carried from the JAX trainer to the port
(``params_from_numpy``, ``adam_state_from_optax``); the batch order is
NumPy's ``default_rng`` in both packages. Tolerances, stated per test:
features rtol=1e-5, atol=1e-6 with labels equal; single steps rtol=1e-5,
atol=1e-6; whole epochs and runs rtol=1e-4, atol=1e-5, the same best init
and thresholds within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syllable_detector_tpu.config.model_format import (
    ProcessingSpec as JProcessingSpec,
    dumps_config as jdumps,
    load_config as jload,
    loads_config as jloads,
)
from syllable_detector_tpu.models.detector import Detector as JDetector
from syllable_detector_tpu.models.neural_net import stack_params as jstack
from syllable_detector_tpu.ops.processing import specs_to_chain as jchain
from syllable_detector_tpu.parallel.mesh import make_mesh as jmesh
from syllable_detector_tpu.training import trainer as jt
from syllable_detector_tpu.utils.synth import make_labeled_audio
from syllable_detector_tpu_torch.config.model_format import dumps_config, save_config
from syllable_detector_tpu_torch.models.detector import Detector
from syllable_detector_tpu_torch.models.neural_net import params_from_numpy
from syllable_detector_tpu_torch.parallel.mesh import make_mesh
from syllable_detector_tpu_torch.training import checkpoint as pc
from syllable_detector_tpu_torch.training import trainer as pt

torch.set_num_threads(1)

KW = dict(epochs=30, batch_size=256, hidden=(4,), learning_rate=3e-3, seed=1)


def settings_pair(**kw):
    kw = {**KW, **kw}
    return jt.TrainSettings(**kw), pt.TrainSettings(**kw)


def host(tree):
    """Leaves of a JAX pytree or a port parameter tree, as numpy, in the
    order of ``jax.tree.leaves`` (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in host(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in host(v)]
    return [np.asarray(tree)]


def assert_trees_close(got, want, rtol, atol):
    got, want = host(got), host(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def carried_inits(seed, sizes, n, channel=None):
    """The JAX trainer's init draws (``fold_in(PRNGKey(seed), i)``, under
    ``fold_in(., channel)`` for an ensemble) as port parameter lists."""
    key = jax.random.PRNGKey(seed)
    if channel is not None:
        key = jax.random.fold_in(key, channel)
    return [
        params_from_numpy(
            jax.tree.map(np.asarray, jt.init_layer_params(jax.random.fold_in(key, i), sizes)),
            "cpu",
        )
        for i in range(n)
    ]


def carry_inits(monkeypatch, draws):
    """Make the port's trainer take ``draws`` in the order it asks for
    inits."""
    it = iter(draws)
    monkeypatch.setattr(pt, "init_layer_params", lambda *a, **k: next(it))


def spy_final_stack(monkeypatch, module, box):
    """Record the stacked parameters a trainer holds after its epochs."""
    real = module._run_training_loop

    def spy(*args, **kwargs):
        params, opt_state = real(*args, **kwargs)
        box.append(params)
        return params, opt_state

    monkeypatch.setattr(module, "_run_training_loop", spy)


@pytest.fixture(scope="module")
def data():
    audio, intervals = make_labeled_audio(3.0)
    js, _ = settings_pair()
    feats, labels = jt.features_and_labels(js, audio, intervals)
    return audio, intervals, feats, labels


def processing(feats, chain=("l2normalize", "mapminmax")):
    """(JAX chain params, port chain params) fit on ``feats``."""
    specs = [jt.fit_mapminmax(feats) if n == "mapminmax" else JProcessingSpec(n) for n in chain]
    out = [JProcessingSpec("mapminmax", x_offsets=np.zeros(1, np.float32),
                           gains=np.full(1, 2.0, np.float32), y_offset=-1.0)]
    j_in, j_out = jchain(specs)[1], jchain(out)[1]
    return (j_in, j_out), (params_from_numpy(jax.tree.map(np.asarray, j_in), "cpu"),
                           params_from_numpy(jax.tree.map(np.asarray, j_out), "cpu"))


BAD_SETTINGS = [
    dict(fourier_length=300),
    dict(fourier_length=256, window_length=512),
    dict(scaling="cube"),
    dict(time_range=0),
    dict(input_processing=("l2normalize", "mapcube")),
    dict(input_processing=("mapstd", "l2normalize")),
]


@pytest.mark.parametrize("bad", BAD_SETTINGS, ids=lambda d: "-".join(map(str, d.values())))
def test_settings_validation_matches_jax(bad):
    """The exporter preamble's checks, with the JAX trainer's messages."""
    with pytest.raises(ValueError) as want:
        jt.TrainSettings(**bad)
    with pytest.raises(ValueError) as got:
        pt.TrainSettings(**bad)
    assert str(got.value) == str(want.value)


def test_settings_properties_match_jax():
    for kw in (dict(), dict(input_processing=["normalizestd", "mapminmax", "mapstd"]),
               dict(freq_range=(500.0, 30000.0), fourier_length=512, window_length=400)):
        j, p = jt.TrainSettings(**kw), pt.TrainSettings(**kw)
        assert (p.bins, p.n_features, p.input_processing) == (j.bins, j.n_features, j.input_processing)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for cls in (jt.TrainSettings, pt.TrainSettings):
        with pytest.raises(ValueError, match="frequency range is invalid"):
            cls(freq_range=(7000.0, 2000.0)).bins
    assert pt.__all__ == jt.__all__


@pytest.mark.parametrize("scaling,silent", [("linear", False), ("log", False), ("db", False),
                                            ("log", True), ("db", True), ("linear", True)])
def test_features_and_labels_match_jax(data, scaling, silent):
    """rtol=1e-5, atol=1e-6, labels equal; a digitally silent stretch stays
    finite under every scaling (the 1e-12 floor)."""
    audio, intervals, _, _ = data
    if silent:
        audio = audio.copy()
        audio[: len(audio) // 4] = 0.0
    js, ps = settings_pair(scaling=scaling)
    want, want_l = jt.features_and_labels(js, audio, intervals)
    got, got_l = pt.features_and_labels(ps, audio, intervals, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_l, want_l)
    assert 0 < got_l.sum() < len(got_l)


@pytest.mark.parametrize("chain", [("l2normalize", "mapminmax"), ("l2normalize", "mapstd"),
                                   ("normalizestd", "mapminmax", "mapstd"), ("mapstd",),
                                   ("passthrough", "normalize", "mapminmax")])
def test_fits_match_jax(data, chain):
    """The float64 fits are the JAX trainer's (equal); the sequential chain
    fit, each stage applied on the port's device, within 1e-6."""
    _, _, feats, _ = data
    for fit in ("fit_mapminmax", "fit_mapstd"):
        a, b = getattr(pt, fit)(feats), getattr(jt, fit)(feats)
        assert (a.name, a.y_offset) == (b.name, b.y_offset)
        np.testing.assert_array_equal(a.x_offsets, b.x_offsets)
        np.testing.assert_array_equal(a.gains, b.gains)
    js, ps = settings_pair(input_processing=chain)
    want_specs, want = jt.fit_input_chain(js, feats)
    got_specs, got = pt.fit_input_chain(ps, feats, device="cpu")
    assert [s.name for s in got_specs] == [s.name for s in want_specs] == list(chain)
    for g, w in zip(got_specs, want_specs):
        if w.x_offsets is not None:
            np.testing.assert_allclose(g.x_offsets, w.x_offsets, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(g.gains, w.gains, rtol=1e-6, atol=1e-6)
            assert g.y_offset == w.y_offset
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_init_layer_params_bounds_and_seed():
    sizes = [290, 4, 1]
    a = pt.init_layer_params(torch.Generator().manual_seed(3), sizes, device="cpu")
    b = pt.init_layer_params(torch.Generator().manual_seed(3), sizes, device="cpu")
    c = pt.init_layer_params(torch.Generator().manual_seed(4), sizes, device="cpu")
    j = jt.init_layer_params(jax.random.PRNGKey(3), sizes)
    assert [tuple(l["w"].shape) for l in a] == [tuple(l["w"].shape) for l in j]
    assert [tuple(l["b"].shape) for l in a] == [tuple(l["b"].shape) for l in j]
    for la, lb, lc, (fan_in, _) in zip(a, b, c, zip(sizes, sizes[1:])):
        assert torch.equal(la["w"], lb["w"]) and not torch.equal(la["w"], lc["w"])
        assert la["w"].dtype == torch.float32
        assert la["w"].abs().max() <= 2.0 / np.sqrt(fan_in) and la["b"].abs().max() <= 2.0


def test_train_step_matches_jax():
    """Five train_step calls from carried JAX params and a carried,
    non-trivial Adam state (three JAX steps in): rtol=1e-5, atol=1e-6 per
    step on the params, the moments and the loss; counts equal; the
    processing params stay frozen."""
    js, ps = settings_pair()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((64, js.n_features)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.float32)
    (j_in, j_out), (p_in, p_out) = processing(feats)
    sizes = [js.n_features, *js.hidden, 1]
    params = {"layers": jt.init_layer_params(jax.random.PRNGKey(0), sizes),
              "process_inputs": j_in, "process_outputs": j_out}
    opt_state = optax.adam(1e-3).init(params["layers"])
    jspec, pspec = jt._build_net_spec(js), pt._build_net_spec(ps)
    for _ in range(3):
        params, opt_state, _ = jt.train_step(jspec, params, opt_state, feats, labels)
    port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    port_state = pt.adam_state_from_optax(jax.tree.map(np.asarray, opt_state), "cpu")
    assert port_state[0].dtype == torch.int32 and int(port_state[0]) == 3
    frozen = [t.copy() for t in host(port["process_inputs"])]
    for step in range(5):
        idx = rng.integers(0, 64, 16)
        params, opt_state, want = jt.train_step(jspec, params, opt_state, feats[idx], labels[idx])
        port, port_state, got = pt.train_step(
            pspec, port, port_state, torch.from_numpy(feats[idx]), torch.from_numpy(labels[idx]))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
        assert_trees_close(port["layers"], params["layers"], 1e-5, 1e-6)
        adam = opt_state[0]
        assert int(port_state[0]) == int(adam.count) == 4 + step
        assert_trees_close(port_state[1:], (adam.mu, adam.nu), 1e-5, 1e-6)
    for a, b in zip(host(port["process_inputs"]), frozen):
        np.testing.assert_array_equal(a, b)


def test_restart_epoch_matches_jax():
    """K=4 ``_make_restart_epoch``: one JAX epoch, then params and the
    per-init Adam state carried to the port, then three epochs side by side
    on the same index tensors: rtol=1e-4, atol=1e-5 after each epoch
    (params, moments, the [S, K] losses)."""
    js, ps = settings_pair(hidden=(3,))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((96, js.n_features)).astype(np.float32)
    labels = (feats[:, 2] > 0).astype(np.float32)
    (j_in, j_out), _ = processing(feats)
    sizes = [js.n_features, *js.hidden, 1]
    stacked = jstack([{"layers": jt.init_layer_params(jax.random.PRNGKey(i), sizes),
                       "process_inputs": j_in, "process_outputs": j_out} for i in range(4)])
    lr = 2e-3
    opt_state = jax.vmap(optax.adam(lr).init)(stacked["layers"])
    jepoch = jt._make_restart_epoch(jt._build_net_spec(js), lr)
    pepoch = pt._make_restart_epoch(pt._build_net_spec(ps), lr)
    fj, lj = jnp.asarray(feats), jnp.asarray(labels)
    fp, lp = torch.from_numpy(feats), torch.from_numpy(labels)

    def idx():
        return rng.permutation(96)[:96].reshape(6, 16).astype(np.int32)

    stacked, opt_state, _ = jepoch(stacked, opt_state, fj, lj, jnp.asarray(idx()))
    port = params_from_numpy(jax.tree.map(np.asarray, stacked), "cpu")
    port_state = pt.adam_state_from_optax(jax.tree.map(np.asarray, opt_state), "cpu")
    assert port_state[0].tolist() == [6] * 4
    for _ in range(3):
        i = idx()
        stacked, opt_state, want = jepoch(stacked, opt_state, fj, lj, jnp.asarray(i))
        port, port_state, got = pepoch(port, port_state, fp, lp, torch.from_numpy(i))
        assert tuple(got.shape) == want.shape == (6, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        assert_trees_close(port, stacked, 1e-4, 1e-5)
        assert_trees_close(port_state[1:], (opt_state[0].mu, opt_state[0].nu), 1e-4, 1e-5)
        np.testing.assert_array_equal(port_state[0].numpy(), np.asarray(opt_state[0].count))


def test_train_matches_jax(data, monkeypatch):
    """Whole ``train`` runs from the carried inits: the same best init (by
    the full-data loss of each package's final stack), weights within
    rtol=1e-4, atol=1e-5, thresholds within 1e-5."""
    _, _, feats, labels = data
    js, ps = settings_pair(epochs=40)
    carry_inits(monkeypatch, carried_inits(js.seed, [js.n_features, 4, 1], js.n_init))
    stacks = []
    spy_final_stack(monkeypatch, jt, stacks)
    spy_final_stack(monkeypatch, pt, stacks)
    jspec, jparams, jthr = jt.train(js, feats, labels)
    pspec, pparams, pthr = pt.train(ps, feats, labels, device="cpu")
    assert pspec == pt._build_net_spec(ps) and pspec.layer_sizes == jspec.layer_sizes
    jfull = np.asarray(jax.vmap(lambda p: jt._loss_fn(jspec, p, feats, labels))(stacks[0]))
    pfull = pt._stacked_loss(pspec, stacks[1], torch.tensor(feats), torch.tensor(labels))
    np.testing.assert_allclose(pfull.numpy(), jfull, rtol=1e-4, atol=1e-5)
    assert int(np.argmin(pfull.numpy())) == int(np.argmin(jfull))
    assert np.ptp(jfull) > 1e-3  # the inits really differ, so the choice is a choice
    assert_trees_close(pparams, jparams, 1e-4, 1e-5)
    assert abs(pthr - jthr) <= 1e-5


def test_train_ensemble_matches_jax(monkeypatch):
    """``train_ensemble`` on two channels of unequal length (the shorter
    wraps its sampling) from the carried channel-major inits: the same best
    init per channel, weights within rtol=1e-4, atol=1e-5, thresholds within
    1e-5."""
    js, ps = settings_pair(epochs=25, n_init=2)
    feats, labels = [], []
    for seed, seconds in ((3, 3.0), (9, 2.0)):
        audio, intervals = make_labeled_audio(seconds, seed=seed)
        f, l = jt.features_and_labels(js, audio, intervals)
        feats.append(f)
        labels.append(l)
    assert len(feats[0]) != len(feats[1])
    sizes = [js.n_features, 4, 1]
    carry_inits(monkeypatch, [p for c in range(2) for p in carried_inits(js.seed, sizes, 2, c)])
    stacks = []
    spy_final_stack(monkeypatch, jt, stacks)
    spy_final_stack(monkeypatch, pt, stacks)
    jspec, jlist, jthr = jt.train_ensemble(js, feats, labels)
    pspec, plist, pthr = pt.train_ensemble(ps, feats, labels, device="cpu")
    assert len(plist) == len(pthr) == 2
    for c in range(2):
        f, l = feats[c], labels[c]
        jmine = jax.tree.map(lambda x: x[2 * c : 2 * c + 2], stacks[0])
        jfull = np.asarray(jax.vmap(lambda p: jt._loss_fn(jspec, p, f, l))(jmine))
        pmine = pt._tree_map(lambda x: x[2 * c : 2 * c + 2], stacks[1])
        pfull = pt._stacked_loss(pspec, pmine, torch.tensor(f), torch.tensor(l)).numpy()
        assert int(np.argmin(pfull)) == int(np.argmin(jfull))
        assert_trees_close(plist[c], jlist[c], 1e-4, 1e-5)
        assert abs(pthr[c] - jthr[c]) <= 1e-5


def test_data_parallel_matches_jax_and_unsharded(data, monkeypatch):
    """The port on a 4-shard CPU data mesh against JAX on
    ``make_mesh(4, axis="data")`` (conftest's virtual CPU devices) and
    against the port unsharded, from the carried inits: weights within
    rtol=1e-4, atol=1e-5, thresholds within 1e-5."""
    _, _, feats, labels = data
    js, ps = settings_pair(epochs=12, batch_size=250)
    draws = carried_inits(js.seed, [js.n_features, 4, 1], js.n_init)
    carry_inits(monkeypatch, draws)
    _, jparams, jthr = jt.train(js, feats, labels, mesh=jmesh(4, axis="data"))
    mesh = make_mesh(4, axis="data", devices=["cpu"])
    _, sharded, sthr = pt.train(ps, feats, labels, mesh=mesh)
    carry_inits(monkeypatch, draws)
    _, whole, wthr = pt.train(
        dataclasses.replace(ps, batch_size=248), feats, labels, device="cpu")
    assert_trees_close(sharded, jparams, 1e-4, 1e-5)
    assert_trees_close(sharded, whole, 1e-4, 1e-5)
    assert abs(sthr - jthr) <= 1e-5 and abs(sthr - wthr) <= 1e-5
    carry_inits(monkeypatch, draws)
    with pytest.raises(ValueError) as want:
        jt.train(js, feats[:3], labels[:3], mesh=jmesh(4, axis="data"))
    with pytest.raises(ValueError) as got:
        pt.train(ps, feats[:3], labels[:3], mesh=mesh)
    assert str(got.value) == str(want.value)


def test_channel_parallel_ensemble_matches_unsharded():
    """The ensemble on a 2-shard channel mesh against unsharded (no
    communication crosses channels): rtol=1e-4, atol=1e-5; three channels
    do not shard over two, with the JAX trainer's message."""
    _, ps = settings_pair(epochs=8, n_init=2, batch_size=64)
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((n, ps.n_features)).astype(np.float32) for n in (130, 90)]
    labels = [(f[:, 0] > 0).astype(np.float32) for f in feats]
    _, single, t_single = pt.train_ensemble(ps, feats, labels, device="cpu")
    mesh = make_mesh(2, axis="channel", devices=["cpu"])
    _, sharded, t_sharded = pt.train_ensemble(ps, feats, labels, mesh=mesh)
    for c in range(2):
        assert_trees_close(sharded[c], single[c], 1e-4, 1e-5)
        assert abs(t_single[c] - t_sharded[c]) <= 1e-5
    js = jt.TrainSettings(**{**KW, "n_init": 1})
    three = (feats + feats[:1], labels + labels[:1])
    with pytest.raises(ValueError) as want:
        jt.train_ensemble(js, *three, mesh=jmesh(2, axis="channel"))
    with pytest.raises(ValueError) as got:
        pt.train_ensemble(dataclasses.replace(ps, n_init=1), *three, mesh=mesh)
    assert str(got.value) == str(want.value) and "shard evenly" in str(got.value)


def test_export_matches_jax(data, tmp_path):
    """``export_trained_config`` on the same numpy params: both packages'
    ``dumps_config`` give byte-equal text, and the port's file loads
    through the JAX ``load_config`` to an equal config."""
    _, _, feats, _ = data
    js, ps = settings_pair(input_processing=("l2normalize", "mapstd"), hidden=(5, 3))
    specs = [JProcessingSpec("l2normalize"), jt.fit_mapstd(feats)]
    (_, j_out), _ = processing(feats)
    sizes = [js.n_features, 5, 3, 1]
    params = {"layers": jt.init_layer_params(jax.random.PRNGKey(7), sizes),
              "process_inputs": jchain(specs)[1], "process_outputs": j_out}
    want = jdumps(jt.export_trained_config(js, jt._build_net_spec(js), params, 0.37))
    cfg = pt.export_trained_config(
        ps, pt._build_net_spec(ps), params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), 0.37)
    assert dumps_config(cfg) == want
    path = tmp_path / "net.txt"
    save_config(cfg, path)
    assert jdumps(jload(path)) == want


def _quality(outs, intervals, settings):
    hop = settings.window_length - settings.window_overlap
    first = settings.window_length + hop * (settings.time_range - 1)
    t = (first + hop * np.arange(len(outs))) / settings.sampling_rate
    inside = np.zeros(len(outs), bool)
    near = np.zeros(len(outs), bool)
    for lo, hi in intervals:
        inside |= (t >= lo) & (t <= hi)
        near |= (t >= lo - 0.1) & (t <= hi + 0.1)
    return inside, near


def test_port_trained_net_detects_in_both_packages():
    """A net trained by the port alone (torch inits) exports, reloads, and
    detects through the port's and the JAX ``Detector`` with the quality of
    the JAX package's ``test_train_and_roundtrip``: in-syllable score above
    out-of-syllable by 0.3, recall > 0.6, false-alarm rate < 0.05. The two
    detectors agree within rtol=1e-4, atol=1e-5."""
    audio, intervals = make_labeled_audio()
    ps = pt.TrainSettings(epochs=300, batch_size=256, hidden=(4,), learning_rate=3e-3, seed=1)
    feats, labels = pt.features_and_labels(ps, audio, intervals, device="cpu")
    net_spec, params, threshold = pt.train(ps, feats, labels, device="cpu")
    text = dumps_config(pt.export_trained_config(ps, net_spec, params, threshold))
    cfg = jloads(text)
    from syllable_detector_tpu_torch.config.model_format import loads_config

    port = Detector(loads_config(text), device="cpu")
    port.append_audio_data(audio)
    got = port.drain()
    jdet = JDetector(cfg)
    jdet.append_audio_data(audio)
    want = jdet.drain()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    inside, near = _quality(got, intervals, ps)
    assert got[inside, 0].mean() > got[~near, 0].mean() + 0.3
    for outs in (got, want):
        detections = outs[:, 0] >= np.float32(cfg.thresholds[0])
        assert detections[inside].mean() > 0.6
        assert detections[~near].mean() < 0.05


def test_checkpoint_roundtrip(tmp_path):
    """The port's checkpoint keeps the JAX module's contract (``step_%08d``
    entries, ``latest_step``, None when empty) and restores into a
    template's structure, dtypes and device."""
    state = {"layers": [{"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(2)}],
             "opt_state": (torch.tensor([7, 7], dtype=torch.int32), np.ones(3, np.float32)),
             "step": 7}
    d = str(tmp_path / "ckpt")
    assert pc.restore_checkpoint(d) is None and pc.latest_step(d) is None
    pc.save_checkpoint(d, 7, state)
    path = pc.save_checkpoint(d, 12, state)
    assert path.endswith("step_00000012")
    (tmp_path / "ckpt" / "step_00000099.tmp").mkdir()  # an unfinished save
    assert pc.latest_step(d) == 12
    plain = pc.restore_checkpoint(d)
    np.testing.assert_array_equal(plain["layers"][0]["w"].numpy(), np.arange(6.0).reshape(2, 3))
    assert plain["step"] == 7
    template = {"layers": [{"w": torch.zeros(2, 3), "b": torch.ones(2)}],
                "opt_state": (torch.zeros(2, dtype=torch.int32), torch.zeros(3)), "step": 0}
    into = pc.restore_checkpoint(d, 7, template=template)
    assert isinstance(into["opt_state"], tuple)
    assert into["opt_state"][0].dtype == torch.int32 and into["opt_state"][0].tolist() == [7, 7]
    assert torch.equal(into["opt_state"][1], torch.ones(3))
    with pytest.raises(ValueError, match="shape"):
        pc.restore_checkpoint(d, template={**template, "layers": [{"w": torch.zeros(3, 2),
                                                                    "b": torch.ones(2)}]})


def test_cuda_without_card_raises(data):
    """The API defaults to the card and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    audio, intervals, feats, labels = data
    _, ps = settings_pair(epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.features_and_labels(ps, audio, intervals)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.train(ps, feats, labels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.train_ensemble(ps, [feats], [labels])
