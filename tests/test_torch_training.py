"""The port's trainer against the JAX trainer on the CPU.

The same seeded inputs go through ``syllable_detector_tpu.training.trainer``
and ``syllable_detector_tpu_torch.training.trainer``. ``jax.random`` draws
cannot be redrawn in torch, so the weight inits (and, for step-level
parity, the optimizer state) are carried from the JAX trainer to the port
(``params_from_numpy``, ``adam_state_from_optax``); the batch order is
NumPy's ``default_rng`` in both packages. Tolerances, stated per test:
features rtol=1e-5, atol=1e-6 with labels equal; single steps rtol=1e-5,
atol=1e-6; whole epochs and runs rtol=1e-4, atol=1e-5, the same best init
and thresholds within 1e-5. The in-place Adam step is held bit for bit
against the out-of-place step it replaced, kept here as its reference.
"""

import ast
import contextlib
import dataclasses
import inspect

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
from syllable_detector_tpu_torch.kernels import peer_exchange
from syllable_detector_tpu_torch.models.detector import Detector
from syllable_detector_tpu_torch.models.neural_net import params_from_numpy, stack_params
from syllable_detector_tpu_torch.parallel.mesh import Mesh, make_mesh
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


def old_adam_update(layers, grads, opt_state, lr):
    """The port's Adam step before it wrote in place: new tensors for the
    layers, the moments and the count, the same operations in the same
    order (the in-place step's reference)."""
    count, mu, nu = opt_state
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(pt._B1, c)
    bc2 = 1 - torch.pow(pt._B2, c)

    def per_net(bc, t):
        return bc.reshape(bc.shape + (1,) * (t.dim() - bc.dim()))

    keys = [(i, k) for i, layer in enumerate(layers) for k in layer]
    p = [layers[i][k] for i, k in keys]
    g = [grads[i][k] for i, k in keys]
    m = torch._foreach_add(
        torch._foreach_mul(g, 1 - pt._B1), torch._foreach_mul([mu[i][k] for i, k in keys], pt._B1))
    v = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - pt._B2),
        torch._foreach_mul([nu[i][k] for i, k in keys], pt._B2))
    m_hat = torch._foreach_div(m, [per_net(bc1, t) for t in m])
    v_hat = torch._foreach_div(v, [per_net(bc2, t) for t in v])
    denom = torch._foreach_add(torch._foreach_sqrt(v_hat), pt._EPS)
    p = torch._foreach_add(p, torch._foreach_mul(torch._foreach_div(m_hat, denom), -lr))

    def tree(values):
        out = [{} for _ in layers]
        for (i, k), t in zip(keys, values):
            out[i][k] = t
        return out

    return tree(p), (count, tree(m), tree(v))


def old_stacked_step(net_spec, lr, params, opt_state, feats, labels):
    values, grads = pt._value_and_grads(
        lambda layers: pt._stacked_loss(net_spec, dict(params, layers=layers), feats, labels),
        params["layers"],
    )
    layers, opt_state = old_adam_update(params["layers"], grads, opt_state, lr)
    return dict(params, layers=layers), opt_state, values


def bits(tree):
    """Every tensor of a tree as raw bytes, in ``jax.tree.leaves`` order."""
    return [a.tobytes() for a in host(tree)]


def port_state(channels, hidden, K, seed):
    """K torch-drawn inits for each channel's features in ``channels``,
    stacked channel-major on the port's leading axis, each channel's
    processing chain fit on its features; and their zero Adam state."""
    gen = torch.Generator().manual_seed(seed)
    nets = []
    for f in channels:
        _, (p_in, p_out) = processing(f)
        nets += [{"layers": pt.init_layer_params(gen, [f.shape[1], *hidden, 1], device="cpu"),
                  "process_inputs": p_in, "process_outputs": p_out} for _ in range(K)]
    params = stack_params(nets)
    return params, pt._adam_init(params["layers"], (len(nets),))


@pytest.mark.parametrize("hidden", [(4,), (8, 4)], ids=["4", "8-4"])
@pytest.mark.parametrize("K", [1, 4])
def test_inplace_step_is_the_old_step_bit_for_bit(K, hidden):
    """Six in-place ``_stacked_step`` calls against the out-of-place step
    they replaced, from one state and on the same batches: losses, layer
    tensors, moments and the int32 count bit for bit equal after every
    step."""
    _, ps = settings_pair(hidden=hidden)
    rng = np.random.default_rng(11 + K)
    feats = rng.standard_normal((80, ps.n_features)).astype(np.float32)
    labels = torch.from_numpy((feats[:, 1] > 0).astype(np.float32))
    params, opt_state = port_state([feats], hidden, K, seed=K)
    spec = pt._build_net_spec(ps)
    old = (params, opt_state)
    new = pt._clone_state(params, opt_state)
    feats = torch.from_numpy(feats)
    for _ in range(6):
        rows = torch.from_numpy(rng.integers(0, 80, 16))
        *old, want = old_stacked_step(spec, 3e-3, *old, feats[rows], labels[rows])
        got = pt._stacked_step(spec, 3e-3, *new, feats[rows], labels[rows])
        assert bits(got) == bits(want)
        assert new[1][0].dtype == torch.int32
        assert bits(new) == bits(old)
    assert new[1][0].tolist() == [6] * K


def ensemble_case(C=3, K=2, bs=8, steps=4, seed=21):
    """(features, labels) of C channels of unequal length, and a draw of
    ``[steps, C, bs]`` index rows within each channel's length."""
    rng = np.random.default_rng(seed)
    ns = [bs * steps + 9 * c for c in range(C)]
    d = pt.TrainSettings().n_features
    feats = [rng.standard_normal((n, d)).astype(np.float32) for n in ns]
    labels = [(f[:, c] > 0).astype(np.float32) for c, f in enumerate(feats)]

    def idx():
        return np.stack([np.take(rng.permutation(n), np.arange(steps * bs), mode="wrap")
                         .reshape(steps, bs) for n in ns], axis=1).astype(np.int32)

    feats_all = np.zeros((C, max(ns), d), np.float32)
    labs_all = np.zeros((C, max(ns)), np.float32)
    for c in range(C):
        feats_all[c, : ns[c]], labs_all[c, : ns[c]] = feats[c], labels[c]
    return feats, feats_all, labs_all, idx


@pytest.mark.parametrize("kind", ["restart", "ensemble"])
def test_epoch_is_functional(kind):
    """A call of the epoch function leaves its inputs unchanged, two calls
    from one state give the same bits, and a call of two epochs equals two
    calls of one. On the CPU the call is its plain per-step loop and
    captures no graph; index rows that are not whole epochs raise."""
    _, ps = settings_pair(hidden=(3,))
    spec = pt._build_net_spec(ps)
    if kind == "restart":
        rng = np.random.default_rng(4)
        feats = rng.standard_normal((64, ps.n_features)).astype(np.float32)
        labels = (feats[:, 0] > 0).astype(np.float32)
        params, opt_state = port_state([feats], (3,), 3, seed=2)
        epoch = pt._make_restart_epoch(spec, 2e-3, steps=4)
        data = (torch.from_numpy(feats), torch.from_numpy(labels))
        idx = torch.from_numpy(np.stack([rng.permutation(64)[:64].reshape(4, 16)
                                         for _ in range(2)]).reshape(8, 16).astype(np.int32))
    else:
        feats, feats_all, labs_all, draw = ensemble_case()
        params, opt_state = port_state(feats, (3,), 2, seed=3)
        epoch = pt.make_ensemble_epoch(spec, 2e-3, n_init=2, steps=4)
        data = (torch.from_numpy(feats_all), torch.from_numpy(labs_all))
        idx = torch.from_numpy(np.concatenate([draw(), draw()]))
    inputs = bits((params, opt_state, *data, idx))
    before = dict(pt.EPOCH_GRAPHS)
    first = epoch(params, opt_state, *data, idx)
    assert bits((params, opt_state, *data, idx)) == inputs
    assert bits(epoch(params, opt_state, *data, idx)) == bits(first)
    assert bits(epoch.plain(params, opt_state, *data, idx)) == bits(first)
    one = epoch(params, opt_state, *data, idx[:4])
    two = epoch(*one[:2], *data, idx[4:])
    assert bits(two[:2]) == bits(first[:2])
    assert bits(torch.cat([one[2], two[2]])) == bits(first[2])
    assert tuple(first[2].shape) == (8, 3 if kind == "restart" else 6)
    assert set(first[1][0].tolist()) == {8}
    assert pt.EPOCH_GRAPHS == before
    with pytest.raises(ValueError, match="not whole epochs of 4 steps"):
        epoch(params, opt_state, *data, idx[:6])


def test_ensemble_epoch_matches_jax():
    """``make_ensemble_epoch`` (3 channels of unequal length, 2 inits each)
    against the JAX ``make_ensemble_epoch``: one JAX epoch, then params and
    the per-init Adam state carried to the port, then three epochs side by
    side on the same index rows, the last two in one call of the port:
    rtol=1e-4, atol=1e-5 after each (params, moments, the [S, C*K] losses),
    counts equal."""
    js, ps = settings_pair(hidden=(3,))
    feats, feats_all, labs_all, draw = ensemble_case()
    nets = []
    for c, f in enumerate(feats):
        (j_in, j_out), _ = processing(f)
        for k in range(2):
            nets.append({"layers": jt.init_layer_params(jax.random.PRNGKey(10 * c + k),
                                                        [js.n_features, 3, 1]),
                         "process_inputs": j_in, "process_outputs": j_out})
    stacked = jstack(nets)
    lr = 2e-3
    opt_state = jax.vmap(optax.adam(lr).init)(stacked["layers"])
    jepoch = jt.make_ensemble_epoch(jt._build_net_spec(js), lr, n_init=2)
    pepoch = pt.make_ensemble_epoch(pt._build_net_spec(ps), lr, n_init=2, steps=4)
    fj, lj = jnp.asarray(feats_all), jnp.asarray(labs_all)
    fp, lp = torch.from_numpy(feats_all), torch.from_numpy(labs_all)
    stacked, opt_state, _ = jepoch(stacked, opt_state, fj, lj, jnp.asarray(draw()))
    port = params_from_numpy(jax.tree.map(np.asarray, stacked), "cpu")
    port_state = pt.adam_state_from_optax(jax.tree.map(np.asarray, opt_state), "cpu")
    assert port_state[0].tolist() == [4] * 6

    def check(got, want, state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        assert_trees_close(port, stacked, 1e-4, 1e-5)
        assert_trees_close(state[1:], (opt_state[0].mu, opt_state[0].nu), 1e-4, 1e-5)
        np.testing.assert_array_equal(state[0].numpy(), np.asarray(opt_state[0].count))

    i = draw()
    stacked, opt_state, want = jepoch(stacked, opt_state, fj, lj, jnp.asarray(i))
    port, port_state, got = pepoch(port, port_state, fp, lp, torch.from_numpy(i))
    assert tuple(got.shape) == want.shape == (4, 6)
    check(got, want, port_state)
    i = np.concatenate([draw(), draw()])
    stacked, opt_state, want = jepoch(stacked, opt_state, fj, lj, jnp.asarray(i))
    port, port_state, got = pepoch(port, port_state, fp, lp, torch.from_numpy(i))
    check(got, want, port_state)


def test_graph_route_has_no_fallback_or_switch():
    """The epoch's route is chosen by the tensors' device alone: no
    ``try`` in the epoch classes, the epoch makers or the loops that call
    them (a failed capture or replay raises, nothing carries on eagerly);
    no environment variable read anywhere in the trainer; and the epoch
    call takes no argument beyond the state, the data and the index rows."""
    src = inspect.getsource(pt)
    tree = ast.parse(src)
    route = {"_Epoch", "_EpochGraph", "_make_restart_epoch", "make_ensemble_epoch",
             "_run_training_loop", "train", "train_ensemble", "_stacked_step", "_adam_update",
             "_capture", "_capture_cards", "_CardsEpochGraph", "_CardsEpoch", "_pmean_update",
             "_batch_grads"}
    nodes = [n for n in tree.body
             if isinstance(n, (ast.ClassDef, ast.FunctionDef)) and n.name in route]
    assert {n.name for n in nodes} == route
    for node in nodes:
        assert not [n for n in ast.walk(node) if isinstance(n, ast.Try)], node.name
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and n.attr in ("environ", "getenv", "environb")]
    assert "getenv" not in src and "environ" not in src
    assert list(inspect.signature(pt._Epoch.__call__).parameters) == [
        "self", "params", "opt_state", "feats", "labels", "idx"]
    assert list(inspect.signature(pt._Epoch).parameters) == ["step", "steps"]
    # ``_Epoch.__call__`` runs whichever graph ``_graph`` built alike
    for graph in (pt._EpochGraph, pt._CardsEpochGraph):
        assert list(inspect.signature(graph.run).parameters) == [
            "self", "params", "opt_state", "idx"]


@pytest.mark.cuda
def test_graph_epoch_equals_plain_on_card():
    """On the card: the restart, ensemble and 4-shard data-mesh epochs'
    graphs against their plain per-step loops from one state over three
    epochs (one capture and three replays each), bit for bit or within
    rtol=1e-6, atol=1e-7; the inputs unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the epoch graph is a CUDA graph)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, ps = settings_pair()
    spec = pt._build_net_spec(ps)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((256, ps.n_features)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.float32)
    feats_e, feats_all, labs_all, draw = ensemble_case()
    cases = [
        (pt._make_restart_epoch(spec, 3e-3, steps=8), *port_state([feats], (4,), 4, seed=1),
         (feats, labels), np.stack([rng.permutation(256)[:256].reshape(8, 32)
                                    for _ in range(3)]).reshape(24, 32)),
        (pt.make_ensemble_epoch(spec, 3e-3, n_init=2, steps=4),
         *port_state(feats_e, (4,), 2, seed=3), (feats_all, labs_all),
         np.concatenate([draw(), draw(), draw()])),
        (pt._make_restart_epoch(spec, 3e-3, mesh=make_mesh(4, axis="data", devices=["cuda:0"]),
                                steps=8), *port_state([feats], (4,), 4, seed=1),
         (feats, labels), np.stack([rng.permutation(256)[:256].reshape(8, 32)
                                    for _ in range(3)]).reshape(24, 32)),
    ]
    for epoch, p, o, data, idx in cases:
        p, o = pt._tree_map(lambda t: t.cuda(), p), tuple(pt._tree_map(lambda t: t.cuda(), o))
        data = tuple(torch.from_numpy(a).cuda() for a in data)
        idx = torch.from_numpy(idx.astype(np.int32)).cuda()
        inputs = bits(pt._tree_map(lambda t: t.cpu(), (p, o, *data, idx)))
        before = dict(pt.EPOCH_GRAPHS)
        got = epoch(p, o, *data, idx)
        want = epoch.plain(p, o, *data, idx)
        torch.cuda.synchronize()
        assert pt.EPOCH_GRAPHS == {"captures": before["captures"] + 1,
                                   "replays": before["replays"] + 3}
        assert bits(pt._tree_map(lambda t: t.cpu(), (p, o, *data, idx))) == inputs
        assert_trees_close(pt._tree_map(lambda t: t.cpu(), got),
                           pt._tree_map(lambda t: t.cpu(), want), 1e-6, 1e-7)


@pytest.mark.cuda
def test_card_graphs_equal_plain_on_cards():
    """On two cards or more: the data mesh of two shards a card, one graph
    a card (one capture each) replayed once an epoch with the gradient
    exchange inside it, against its plain per-step loop from one state
    over two epochs bit for bit (or within rtol=1e-6, atol=1e-7); every
    card's replica bit for bit card 0's; the results on card 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (the gradients cross cards)")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec, params, opt_state, feats, labels, idx = mesh_case(K=4, n=256, bs=64)
    n = torch.cuda.device_count()
    mesh = make_mesh(2 * n, axis="data")
    epoch = pt._make_restart_epoch(spec, 3e-3, mesh=mesh, steps=4)
    state = pt._tree_map(lambda t: t.cuda(), (params, opt_state, feats, labels, idx))
    before = dict(pt.EPOCH_GRAPHS)
    got = epoch(*state)
    want = epoch.plain(*state)
    torch.cuda.synchronize()
    assert pt.EPOCH_GRAPHS == {"captures": before["captures"] + n,
                               "replays": before["replays"] + n * (len(idx) // 4)}
    assert {t.device for t in pt._leaves(got)} == {mesh.devices[0]}
    graph, = epoch.graphs.values()
    for c in range(1, n):
        assert bits(pt._tree_map(lambda t: t.cpu(), (graph.params[c], graph.opt_state[c]))) == \
            bits(pt._tree_map(lambda t: t.cpu(), (graph.params[0], graph.opt_state[0])))
    assert_trees_close(pt._tree_map(lambda t: t.cpu(), got),
                       pt._tree_map(lambda t: t.cpu(), want), 1e-6, 1e-7)


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


def test_one_shard_data_mesh_is_unsharded_bit_for_bit(data, monkeypatch):
    """``train`` on a one-shard data mesh: the parameters and threshold of
    unsharded training bit for bit (the sum of one shard's part is that
    part, and a division by 1 is exact), and so the final stack of every
    init and its Adam state."""
    _, _, feats, labels = data
    _, ps = settings_pair(epochs=12)
    states = []
    real = pt._run_training_loop

    def spy(*args, **kwargs):
        states.append(real(*args, **kwargs))
        return states[-1]

    monkeypatch.setattr(pt, "_run_training_loop", spy)
    _, whole, t_whole = pt.train(ps, feats, labels, device="cpu")
    _, one, t_one = pt.train(ps, feats, labels, mesh=make_mesh(1, axis="data", devices=["cpu"]))
    assert bits(one) == bits(whole) and t_one == t_whole
    assert bits(states[1]) == bits(states[0])


def mesh_case(K=3, n=96, bs=32, seed=6):
    """A state of K inits, data of ``n`` rows, and two epochs of ``[n // bs,
    bs]`` index rows."""
    _, ps = settings_pair(hidden=(3,))
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, ps.n_features)).astype(np.float32)
    labels = (feats[:, 1] > 0).astype(np.float32)
    params, opt_state = port_state([feats], (3,), K, seed=seed)
    idx = np.concatenate([rng.permutation(n)[: n // bs * bs].reshape(-1, bs) for _ in range(2)])
    return (pt._build_net_spec(ps), params, opt_state, torch.from_numpy(feats),
            torch.from_numpy(labels), torch.from_numpy(idx.astype(np.int32)))


@pytest.mark.parametrize("K", [1, 4])
def test_data_mesh_step_is_the_shard_order_mean(K):
    """Three steps of the 4-shard CPU data mesh, bit for bit three steps
    written out here: each shard's ``_value_and_grads`` on its quarter of
    the row's columns, losses and gradients summed in shard order and
    divided by 4, then ``_adam_update``. The sum in the reverse order gives
    other bits, so the order is what the comparison holds."""
    spec, params, opt_state, feats, labels, idx = mesh_case(K)
    mesh = make_mesh(4, axis="data", devices=["cpu"])
    epoch = pt._make_restart_epoch(spec, 2e-3, mesh=mesh, steps=1)
    got_state, want_state = pt._clone_state(params, opt_state), pt._clone_state(params, opt_state)
    reverse_differs = False
    for row in idx[:3]:
        got = epoch.step(*got_state, feats, labels, row)
        p, o = want_state
        parts = [pt._value_and_grads(
            lambda layers, cols=cols: pt._stacked_loss(
                spec, dict(p, layers=layers), feats[cols.long()], labels[cols.long()]),
            p["layers"]) for cols in row.view(4, -1)]

        def mean(tensors):
            total = tensors[0]
            for t in tensors[1:]:
                total = total + t
            return total / 4

        grads = [{k: mean([q[1][j][k] for q in parts]) for k in layer}
                 for j, layer in enumerate(p["layers"])]
        reverse = [{k: mean([q[1][j][k] for q in parts[::-1]]) for k in layer}
                   for j, layer in enumerate(p["layers"])]
        reverse_differs |= bits(reverse) != bits(grads)
        pt._adam_update(p["layers"], grads, o, 2e-3)
        assert bits(got) == bits(mean([q[0] for q in parts]))
        assert bits(got_state) == bits(want_state)
    assert reverse_differs
    assert got_state[1][0].tolist() == [3] * K


def test_mesh_epoch_routes():
    """A data mesh whose shards lie on one device gives the plain
    :class:`_Epoch` of the mesh step, carrying the epoch's ``steps`` (on a
    card, one graph replay an epoch); shards on several cards give a
    ``_CardsEpoch``, its cards in the order of their first shard."""
    spec = pt._build_net_spec(settings_pair()[1])
    for devices, shards in ((["cpu"], 4), (["cpu"], 1), (["cuda:0"], 4), (["cuda:0"], 1)):
        epoch = pt._make_restart_epoch(
            spec, 1e-3, mesh=make_mesh(shards, axis="data", devices=devices), steps=7)
        assert type(epoch) is pt._Epoch and epoch.steps == 7
    cards = [torch.device("cuda", i) for i in range(4)]
    mesh = make_mesh(8, axis="data", devices=cards)
    epoch = pt._make_restart_epoch(spec, 1e-3, mesh=mesh, steps=7)
    assert type(epoch) is pt._CardsEpoch and epoch.steps == 7 and epoch.mesh == mesh
    assert pt._cards(mesh) == [(cards[i], [i, i + 4]) for i in range(4)]


def test_resumed_data_mesh_run_is_bit_for_bit(data, tmp_path):
    """``train`` on a 4-shard data mesh, interrupted after 3 of 5 epochs
    (a checkpoint every epoch) and resumed: the parameters and threshold
    of the uninterrupted run bit for bit."""
    _, _, feats, labels = data
    _, ps = settings_pair(epochs=5)
    mesh = make_mesh(4, axis="data", devices=["cpu"])
    _, full, t_full = pt.train(ps, feats, labels, mesh=mesh)
    d = str(tmp_path / "ckpt")
    pt.train(dataclasses.replace(ps, epochs=3), feats, labels, mesh=mesh, checkpoint_dir=d,
             checkpoint_every=1)
    _, resumed, t_resumed = pt.train(ps, feats, labels, mesh=mesh, checkpoint_dir=d,
                                     checkpoint_every=1)
    assert bits(resumed) == bits(full) and t_resumed == t_full


class EagerCards:
    """Stands in for the cards' CUDA graphs on the CPU: the last card's
    replay of an epoch runs every card's phases, phase by phase across the
    cards, so that each card's push of a step comes before any card's
    wait of it (on the cards the waits spin until the pushes land)."""

    def __init__(self, phases):
        self.phases, self.replayed = phases, 0

    def replay(self):
        self.replayed += 1
        if self.replayed % len(self.phases) == 0:
            for k in range(len(self.phases[0])):
                for card in self.phases:
                    card[k]()


def eager_cards(warms, phases, devices):
    for k in range(len(warms[0])):
        for card in warms:
            card[k]()
    graph = EagerCards(phases)
    return [(graph, [None] * len(card), 0) for card in phases]


@pytest.mark.parametrize("devices, shards", [
    (("cpu", "cpu:0", "cpu", "cpu:0"), [[0, 2], [1, 3]]),
    (("cpu", "cpu:0", "cpu:0", "cpu:1"), [[0], [1, 2], [3]]),
    (("cpu", "cpu:1", "cpu:0", "cpu:1"), [[0], [1, 3], [2]]),
], ids=["round-robin", "uneven", "interleaved"])
def test_cards_epoch_graph_host_logic(devices, shards, monkeypatch):
    """The multi-card route on CPU devices standing in for cards (``cpu``,
    ``cpu:0`` and ``cpu:1`` are distinct devices to the mesh) and a
    stand-in for the capture that runs each card's phases (grads and push,
    then wait, sum and update, a step at a time) phase by phase across the
    cards at the last card's replay, through the exchange's plain version.
    Two epochs of 3 steps (an odd count, so the slot parity of an epoch's
    first step alternates) of the ``_CardsEpoch``'s per-step loop and of
    its graphs, bit for bit the one-device mesh epoch: so every card sums
    the shards in shard order. The inputs are unchanged; one graph a card
    is captured and each replayed once an epoch; every card's replica is
    bit for bit card 0's; each card's row buffer holds its shards' columns
    in shard order; every card's flags hold the last step + 1 of every
    source; the other cards' data are copies; the results lie on card 0's
    device in the caller's key order; a second call reuses every buffer and
    gives the same bits; the plain versions count no kernel launch. What
    only the card checks: the capture, the kernels, the peer stores and
    the waits between cards."""
    spec, params, opt_state, feats, labels, idx = mesh_case(K=2)
    mesh = Mesh(tuple(torch.device(d) for d in devices), ("data",))
    cards = pt._cards(mesh)
    assert [mine for _, mine in cards] == shards
    epoch = pt._make_restart_epoch(spec, 2e-3, mesh=mesh, steps=3)
    assert type(epoch) is pt._CardsEpoch
    want = pt._make_restart_epoch(
        spec, 2e-3, mesh=make_mesh(4, axis="data", devices=["cpu"]), steps=3
    )(params, opt_state, feats, labels, idx)
    inputs = bits((params, opt_state, feats, labels, idx))
    before, launches = dict(pt.EPOCH_GRAPHS), dict(peer_exchange.LAUNCHES)
    assert bits(epoch(params, opt_state, feats, labels, idx)) == bits(want)
    assert pt.EPOCH_GRAPHS == before
    monkeypatch.setattr(pt, "_capture_cards", eager_cards)
    graphs = epoch._graph(params, opt_state, feats, labels, idx[:3])
    assert pt.EPOCH_GRAPHS == {"captures": before["captures"] + len(cards),
                               "replays": before["replays"]}

    def buffers():
        return [t.data_ptr() for t in pt._leaves((
            graphs.params, graphs.opt_state, graphs.data, graphs.parts, graphs.shard_of,
            graphs.slots, graphs.flags, graphs.ready, graphs.base, graphs.errors, graphs.rows,
            graphs.values))]

    kept = buffers()
    got = graphs.run(params, opt_state, idx)
    assert bits((params, opt_state, feats, labels, idx)) == inputs
    assert bits(got) == bits(want)
    assert pt.EPOCH_GRAPHS["replays"] == before["replays"] + len(cards) * 2
    local = idx.shape[1] // 4
    for c, (_, mine) in enumerate(cards):
        assert bits((graphs.params[c], graphs.opt_state[c])) == bits((graphs.params[0],
                                                                      graphs.opt_state[0]))
        assert torch.equal(graphs.rows[c], torch.cat([idx[3:, i * local:(i + 1) * local]
                                                      for i in mine], 1))
        assert graphs.parts[c].shape[0] == len(mine) and graphs.shard_of[c].tolist() == mine
        assert graphs.flags[c].tolist() == [graphs.issued] * len(cards)
        if c:
            assert graphs.data[c][0].data_ptr() != feats.data_ptr()
            assert torch.equal(graphs.data[c][0], feats)
    assert graphs.issued == 3 + len(idx)  # the warm-up's steps, then the call's
    assert graphs.data[0][0] is feats
    assert {t.device for t in pt._leaves(got)} == {cards[0][0]}
    assert list(got[0]) == list(params)  # the caller's key order, which leaf walks follow
    assert bits(graphs.run(params, opt_state, idx)) == bits(want)
    assert buffers() == kept
    assert peer_exchange.LAUNCHES == launches
    with pytest.raises(ValueError, match="not on shard 0's"):
        pt._CardsEpochGraph(spec, 2e-3, cards[1:] + cards[:1], params, opt_state,
                            feats, labels, idx[:3])


def test_capture_cards_warms_phase_by_phase(monkeypatch):
    """``_capture_cards`` with the CUDA calls it makes recorded on the CPU:
    every card synchronised before any warm-up; the warm-ups run phase by
    phase across the cards (a card's phase k only once every card has run
    its phases before k, since a card's wait needs the others' pushes and a
    kernel's first load may wait for its card), each under its card and its
    own side stream; every card's warm-up done before any capture; then
    each card's phases captured in order on that stream, what they return
    kept card by card."""
    log = []

    class Stream:
        def __init__(self, device):
            self.device = device

        def wait_stream(self, other):
            log.append(("wait_stream", self.device))

    @contextlib.contextmanager
    def scope(kind, value):
        log.append((kind, value))
        yield

    class Graph:
        pass

    @contextlib.contextmanager
    def graph(g, stream):
        log.append(("capture", stream.device))
        yield

    current = {}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d: log.append(("sync", d)))
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: current.setdefault(d, Stream(d)))
    monkeypatch.setattr(torch.cuda, "device", lambda d: scope("device", d))
    monkeypatch.setattr(torch.cuda, "stream", lambda st: scope("stream", st.device))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    devices = ["card0", "card1", "card2"]

    def phase(kind, c, k):
        return lambda: log.append((kind, c, k)) or (c, k)

    warms = [[phase("warm", c, k) for k in range(4)] for c in range(3)]
    bodies = [[phase("body", c, k) for k in range(2 + c)] for c in range(3)]
    captured = pt._capture_cards(warms, bodies, devices)
    warm_runs = [e for e in log if e[0] == "warm"]
    assert warm_runs == [("warm", c, k) for k in range(4) for c in range(3)]
    first_warm = log.index(warm_runs[0])
    assert [e for e in log[:first_warm] if e[0] == "sync"] == [("sync", d) for d in devices]
    for c, dev in enumerate(devices):
        at = log.index(("warm", c, 0))
        assert log[at - 2:at] == [("device", dev), ("stream", dev)]
    last_warm, first_capture = log.index(warm_runs[-1]), log.index(("capture", "card0"))
    assert [e for e in log[last_warm:first_capture] if e[0] == "sync"] == [
        ("sync", d) for d in devices]
    assert [e for e in log if e[0] == "body"] == [("body", c, k) for c in range(3)
                                                  for k in range(2 + c)]
    assert [outs for _, outs, _ in captured] == [[(c, k) for k in range(2 + c)]
                                                 for c in range(3)]
    assert all(isinstance(g, Graph) and pool == 0 for g, _, pool in captured)


@pytest.mark.parametrize("step", [6, 7], ids=["even step", "odd step"])
def test_exchange_plain_version_lands_rows_in_shard_order(step):
    """The exchange's plain version on three stand-in cards holding shards
    [0, 3], [1] and [2]: each card's push puts its rows into the rows of
    their shards in the step's parity slot of every card, and leaves the
    other slot as it was; every card's flag of each source holds the step +
    1; a wait copies the step's slot out in shard order, and raises for a
    step whose rows have not landed; ``check`` raises where an error word
    is set; the plain versions count no launch."""
    cards, shards, width = [[0, 3], [1], [2]], 4, 5
    rng = np.random.default_rng(step)
    rows = [torch.from_numpy(rng.standard_normal((len(m), width)).astype(np.float32))
            for m in cards]
    slots = [torch.full((2, shards, width), -1.0) for _ in cards]
    flags = [torch.zeros(len(cards), dtype=torch.long) for _ in cards]
    base, error = torch.tensor([step - 2]), torch.zeros(1, dtype=torch.int32)
    launches = dict(peer_exchange.LAUNCHES)
    for c, mine in enumerate(cards):
        peer_exchange.push(rows[c], torch.tensor(mine, dtype=torch.int32), slots, flags, c,
                           base, 2)
    want = torch.cat(rows)[torch.tensor([0, 2, 3, 1])]
    for c in range(len(cards)):
        assert torch.equal(slots[c][step % 2], want)
        assert (slots[c][1 - step % 2] == -1).all()
        assert flags[c].tolist() == [step + 1] * len(cards)
    ready = torch.zeros(shards, width)
    peer_exchange.wait(flags[1], slots[1], ready, base, 2, error)
    assert torch.equal(ready, want)
    with pytest.raises(RuntimeError, match=r"card\(s\) \[0, 1, 2\] have not landed"):
        peer_exchange.wait(flags[1], slots[1], ready, base, 3, error)
    peer_exchange.check([error] * 3)
    with pytest.raises(RuntimeError, match="cpu waited for card 2's rows"):
        peer_exchange.check([error, torch.tensor([3], dtype=torch.int32)])
    assert peer_exchange.LAUNCHES == launches


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
