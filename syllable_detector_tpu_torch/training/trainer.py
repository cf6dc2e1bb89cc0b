"""Train syllable-detector MLPs on a CUDA card.

Counterpart of ``syllable_detector_tpu.training.trainer``, which replaces
the reference's MATLAB pipeline: compute the spectrogram features the
detector consumes at inference time (hop-strided hamming band DFT
magnitudes, stacked over timeRange frames), fit the MATLAB-style input
mapping, then train the tansig/purelin MLP with Adam against [0, 1] syllable
labels. The trained net exports through ``config.save_config`` to the text
format MATLAB's exporter writes, so the reference app and both packages load
it.

K weight inits train side by side on a leading axis of every layer tensor
(the JAX package vmaps them); an ensemble of C per-channel nets stacks
``C * K`` of them, channel-major. A step is the loss of every init on one
batch (the forward pass broadcast over the stacked axis), autograd on the
stacked layer tensors (the summed loss has each init's gradient in its own
slice), and one elementwise Adam update in optax's order of operations. Where the
JAX package runs a whole epoch as one device program (``lax.scan`` over the
steps), this package dispatches every step from Python; the batches are
still gathered on the device from the resident feature array, with one
``[S, bs]`` index tensor uploaded per chunk of epochs.

With a :class:`~syllable_detector_tpu_torch.parallel.mesh.Mesh` on the data
axis, each step's batch columns split over the shards, each shard computes
its gradients on its own stream, the gradients and losses are averaged in
shard order (the JAX package's ``pmean``) and one update is applied. On the
channel axis of an ensemble, each shard trains its own whole channels.

Tensors are made on ``device`` (default ``"cuda"``, which raises without a
card); ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch

from syllable_detector_tpu_torch.config.model_format import (
    LayerSpec,
    ProcessingSpec,
    SyllableDetectorConfig,
    first_output_sample,
)
from syllable_detector_tpu_torch.models.detector import WINDOW
from syllable_detector_tpu_torch.models.neural_net import (
    NetSpec,
    apply_net,
    params_from_numpy,
    stack_params,
)
from syllable_detector_tpu_torch.ops.processing import (
    apply_input_chain,
    apply_named,
    reverse_output_chain,
    specs_to_chain,
)
from syllable_detector_tpu_torch.ops.scaling import apply_scaling
from syllable_detector_tpu_torch.ops.transfer import apply_transfer
from syllable_detector_tpu_torch.ops.stft import (
    frame_signal,
    frequency_index_range,
    num_frames,
    spectral_frames,
    stack_features,
)
from syllable_detector_tpu_torch.parallel.mesh import (
    Mesh,
    _gather,
    _leaves,
    _on_shards,
    _psum,
    _tree_map,
)

__all__ = [
    "TrainSettings",
    "features_and_labels",
    "fit_input_chain",
    "fit_mapminmax",
    "fit_mapstd",
    "init_layer_params",
    "train",
    "train_ensemble",
    "train_step",
    "make_ensemble_epoch",
    "export_trained_config",
]

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainSettings:
    """Spectrogram + net hyperparameters (the convert_to_text.m preamble:
    samplerate/FFT_SIZE/freq_range/time_window, convert_to_text.m:23-66)."""

    sampling_rate: float = 44100.0
    fourier_length: int = 256
    window_length: int = 256
    window_overlap: int = 124
    freq_range: tuple[float, float] = (2000.0, 7000.0)
    time_range: int = 10
    scaling: str = "linear"
    # input processing chain to fit and export: parameter-free stages
    # (l2normalize/normalize/normalizestd/passthrough) precede the fitted
    # affine stages (mapminmax/mapstd), as the exporter prepends them and as
    # the fused kernel's constant folding expects
    input_processing: tuple[str, ...] = ("l2normalize", "mapminmax")
    hidden: tuple[int, ...] = (4,)
    learning_rate: float = 1e-3
    epochs: int = 200
    batch_size: int = 4096
    seed: int = 0
    # independent weight inits trained side by side; the best by full-data
    # loss is kept. The tiny MLP has a mean-prediction plateau (hidden units
    # initialized too alike never differentiate) that traps a fraction of
    # random inits; restarts make training reliable.
    n_init: int = 4

    def __post_init__(self):
        # the MATLAB exporter's preamble validation (convert_to_text.m:41-54)
        if self.fourier_length & (self.fourier_length - 1):
            raise ValueError(
                f"fourier_length must be a power of 2, got {self.fourier_length}"
            )
        if self.window_length > self.fourier_length:
            raise ValueError(
                f"window_length ({self.window_length}) must not exceed "
                f"fourier_length ({self.fourier_length})"
            )
        if self.scaling not in ("linear", "log", "db"):
            raise ValueError(f"unknown scaling {self.scaling!r}")
        if self.time_range < 1:
            raise ValueError("time_range must be >= 1")
        self.input_processing = tuple(self.input_processing)
        free = ("l2normalize", "normalize", "normalizestd", "passthrough")
        fitted = ("mapminmax", "mapstd")
        seen_fitted = False
        for name in self.input_processing:
            if name in fitted:
                seen_fitted = True
            elif name in free:
                if seen_fitted:
                    raise ValueError(
                        f"parameter-free stage {name!r} must precede the "
                        f"fitted affine stages in input_processing "
                        f"{self.input_processing!r} (the exporter prepends "
                        "them before the net's processFcns)"
                    )
            else:
                raise ValueError(
                    f"unknown input processing function {name!r}; expected "
                    f"one of {free + fitted}"
                )

    @property
    def bins(self) -> tuple[int, int]:
        b = frequency_index_range(
            self.fourier_length, self.freq_range[0], self.freq_range[1],
            self.sampling_rate,
        )
        if b is None:
            raise ValueError("The frequency range is invalid.")
        return b

    @property
    def n_features(self) -> int:
        lo, hi = self.bins
        return (hi - lo) * self.time_range


def _device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)"
        )
    return device


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def features_and_labels(
    settings: TrainSettings,
    audio: np.ndarray,
    intervals: list[tuple[float, float]],
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Audio + labeled syllable intervals (seconds) -> (features [E, D],
    labels [E] in {0, 1}), as numpy arrays; the spectrogram is computed on
    ``device``.

    An evaluation is positive when its decision sample (the reference's
    sample accounting, TrackDetector.swift:38-42) falls inside an interval.
    """
    device = _device(device)
    audio = np.asarray(audio, np.float32).reshape(-1)
    f = num_frames(len(audio), settings.window_length, settings.window_overlap)
    frames = frame_signal(
        torch.tensor(audio, device=device), f, settings.window_length,
        settings.window_overlap,
    )
    band = spectral_frames(
        frames,
        settings.fourier_length,
        window_type=WINDOW,
        bins=settings.bins,
        kind="magnitude",
    )
    # scale as detect_features does at inference. Training only: floor
    # exact-zero magnitudes first, since digitally silent windows would make
    # log/db emit -inf and l2normalize divide 0/0, poisoning the mapminmax
    # fit and every gradient after it
    stacked = torch.clamp(stack_features(band, settings.time_range), min=1e-12)
    feats = _host(apply_scaling(stacked, settings.scaling))

    hop = settings.window_length - settings.window_overlap
    first = first_output_sample(
        settings.window_length, settings.window_overlap, settings.time_range
    )
    decision_samples = first + hop * np.arange(len(feats))
    t = decision_samples / settings.sampling_rate
    labels = np.zeros(len(feats), np.float32)
    for lo, hi in intervals:
        labels[(t >= lo) & (t <= hi)] = 1.0
    return feats, labels


def fit_mapminmax(features: np.ndarray) -> ProcessingSpec:
    """MATLAB mapminmax fit: per-feature map of [xmin, xmax] -> [-1, 1]
    (gains = 2/(xmax - xmin), xOffsets = xmin, yMin = -1;
    NeuralNet.swift:111-131). Zero-range features get gain 1."""
    xmin = features.min(axis=0).astype(np.float64)
    xmax = features.max(axis=0).astype(np.float64)
    rng = xmax - xmin
    gains = np.where(rng > 0, 2.0 / np.where(rng > 0, rng, 1.0), 1.0)
    return ProcessingSpec(
        name="mapminmax",
        x_offsets=xmin.astype(np.float32),
        gains=gains.astype(np.float32),
        y_offset=-1.0,
    )


def fit_mapstd(features: np.ndarray) -> ProcessingSpec:
    """MATLAB mapstd fit: per-feature map to mean 0, std 1
    (gains = ystd/xstd with ystd = 1 and the N-1 sample std MATLAB's
    std() computes, xOffsets = mean, yMean = 0; applied exactly as
    NeuralNet.swift:162-168). Zero-variance features get gain 1,
    mirroring :func:`fit_mapminmax`'s zero-range rule."""
    mean = features.mean(axis=0, dtype=np.float64)
    n = len(features)
    std = (
        features.std(axis=0, ddof=1, dtype=np.float64)
        if n > 1
        else np.zeros_like(mean)
    )
    gains = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
    return ProcessingSpec(
        name="mapstd",
        x_offsets=mean.astype(np.float32),
        gains=gains.astype(np.float32),
        y_offset=0.0,
    )


def fit_input_chain(
    settings: TrainSettings, features: np.ndarray, device="cuda"
) -> tuple[list[ProcessingSpec], np.ndarray]:
    """Fit ``settings.input_processing`` sequentially: each fitted affine
    stage (mapminmax/mapstd) is fit on the features as transformed by the
    stages before it, as MATLAB configures its processFcns. The fits are
    float64 NumPy; each stage is applied on ``device``. Returns the fitted
    specs and the fully transformed features (numpy)."""
    device = _device(device)
    specs: list[ProcessingSpec] = []
    for name in settings.input_processing:
        if name == "mapminmax":
            spec = fit_mapminmax(features)
        elif name == "mapstd":
            spec = fit_mapstd(features)
        else:
            spec = ProcessingSpec(name)
        p = specs_to_chain([spec], device)[1][0]
        features = _host(apply_named(torch.tensor(features, device=device), name, p))
        specs.append(spec)
    return specs, features


def init_layer_params(
    generator: torch.Generator, sizes: list[int], scale: float = 2.0, device="cuda"
) -> list[dict]:
    """Uniform init, bounds ``scale/sqrt(fan_in)`` (weights) and ``scale``
    (biases), drawn from ``generator`` (a CPU ``torch.Generator``) and
    placed on ``device``. Scale 2.0 spreads the hidden tansig units'
    active regions so that few inits collapse onto the mean-prediction
    plateau. The draws differ from ``jax.random``'s, whose bits torch cannot
    reproduce."""
    device = _device(device)
    params = []
    for i in range(len(sizes) - 1):
        bound = scale / np.sqrt(sizes[i])
        w = torch.empty(sizes[i + 1], sizes[i]).uniform_(-bound, bound, generator=generator)
        b = torch.empty(sizes[i + 1]).uniform_(-scale, scale, generator=generator)
        params.append({"w": w.to(device), "b": b.to(device)})
    return params


def _build_net_spec(settings: TrainSettings) -> NetSpec:
    sizes = [settings.n_features, *settings.hidden, 1]
    transfers = tuple(["TanSig"] * len(settings.hidden) + ["PureLin"])
    return NetSpec(
        layer_sizes=tuple((sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)),
        transfers=transfers,
        input_processing=settings.input_processing,
        output_processing=("mapminmax",),
    )


def _loss_fn(net_spec: NetSpec, params, feats, labels):
    preds = apply_net(net_spec, params, feats)[..., 0]
    return torch.mean((preds - labels) ** 2)


def _value_and_grads(loss_of_layers, layers):
    """(loss values, gradients shaped as ``layers``). ``loss_of_layers``
    gives one loss per stacked net; every net's loss depends only on its own
    slice of the layer tensors, so the gradient of their sum holds each
    net's own gradient in its slice. The processing parameters are not
    differentiated (frozen)."""
    leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()} for layer in layers]
    with torch.enable_grad():
        values = loss_of_layers(leaves)
        grads = torch.autograd.grad(values.sum(), _leaves(leaves))
    it = iter(grads)
    return values.detach(), [{k: next(it) for k in layer} for layer in layers]


def _adam_init(layers, count_shape=()) -> tuple:
    """optax.adam's state for ``layers`` as ``(count, mu, nu)``: an int32
    step count (one per stacked net: ``count_shape``) and zero moments."""
    device = _leaves(layers)[0].device
    zeros = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in layers]
    return (
        torch.zeros(count_shape, dtype=torch.int32, device=device),
        zeros,
        [{k: v.clone() for k, v in layer.items()} for layer in zeros],
    )


def _adam_update(layers, grads, opt_state, lr: float):
    """One optax.adam step, elementwise over the stacked nets, in optax's
    order of operations: moments ``(1-b)*g**k + b*m``, bias corrections
    ``1 - b**count`` in float32 per net, ``m_hat / (sqrt(v_hat) + eps)``
    scaled by ``-lr`` and added. ``torch.optim.Adam`` folds the corrections
    in another order and drifts from optax in the last bits. Each operation
    runs over all layer tensors at once (``torch._foreach_*``: one launch
    for the list on a card, where the step is bound by launches)."""
    count, mu, nu = opt_state
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(_B1, c)
    bc2 = 1 - torch.pow(_B2, c)

    def per_net(bc, t):  # the stacked nets' corrections along t's lead axes
        return bc.reshape(bc.shape + (1,) * (t.dim() - bc.dim()))

    keys = [(i, k) for i, layer in enumerate(layers) for k in layer]
    p = [layers[i][k] for i, k in keys]
    g = [grads[i][k] for i, k in keys]
    m = torch._foreach_add(
        torch._foreach_mul(g, 1 - _B1), torch._foreach_mul([mu[i][k] for i, k in keys], _B1))
    v = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - _B2),
        torch._foreach_mul([nu[i][k] for i, k in keys], _B2))
    m_hat = torch._foreach_div(m, [per_net(bc1, t) for t in m])
    v_hat = torch._foreach_div(v, [per_net(bc2, t) for t in v])
    denom = torch._foreach_add(torch._foreach_sqrt(v_hat), _EPS)
    p = torch._foreach_add(p, torch._foreach_mul(torch._foreach_div(m_hat, denom), -lr))

    def tree(values):
        out = [{} for _ in layers]
        for (i, k), t in zip(keys, values):
            out[i][k] = t
        return out

    return tree(p), (count, tree(m), tree(v))


def adam_state_from_optax(state, device="cuda") -> tuple:
    """The JAX trainer's ``optax.adam`` state with numpy leaves (as
    ``jax.tree.map(np.asarray, opt_state)`` gives it: the chain's tuple
    ``(ScaleByAdamState(count, mu, nu), EmptyState())`` or the
    ``ScaleByAdamState`` alone, per init or stacked) as this package's
    ``(count, mu, nu)`` on ``device``."""
    device = _device(device)
    adam = state if hasattr(state, "mu") else state[0]
    return (
        torch.tensor(np.asarray(adam.count, np.int32), device=device),
        params_from_numpy(adam.mu, device),
        params_from_numpy(adam.nu, device),
    )


def train_step(net_spec: NetSpec, params, opt_state, feats, labels, lr=1e-3):
    """One Adam step on the layer weights of one net (processing params
    frozen) -> (params, opt_state, loss before the step). ``opt_state`` is
    ``(count, mu, nu)`` (see :func:`adam_state_from_optax`)."""
    value, grads = _value_and_grads(
        lambda layers: _loss_fn(net_spec, dict(params, layers=layers), feats, labels),
        params["layers"],
    )
    layers, opt_state = _adam_update(params["layers"], grads, opt_state, lr)
    return dict(params, layers=layers), opt_state, value


def _stacked_apply(net_spec: NetSpec, params, x, lead: int = 1):
    """:func:`apply_net` of nets stacked on ``lead`` leading axes of every
    parameter tensor (``[K, ...]``, or ``[C, K, ...]`` with ``lead=2``), on
    inputs ``x [..., bs, D]`` that broadcast against those axes ->
    ``[*stack, bs, outputs]``. The same operations as ``torch.func.vmap`` of
    :func:`apply_net` over the stack, without vmap's dispatch cost per
    operation."""

    def lift(t):  # a per-net scalar or vector, broadcast over the batch rows
        return t.reshape(t.shape + (1, 1)) if t.dim() == lead else t.unsqueeze(-2)

    x = apply_input_chain(
        x, net_spec.input_processing,
        [{k: lift(v) for k, v in p.items()} for p in params["process_inputs"]],
    )
    for transfer, layer in zip(net_spec.transfers, params["layers"]):
        x = apply_transfer(
            torch.matmul(x, layer["w"].transpose(-1, -2)) + layer["b"].unsqueeze(-2),
            transfer,
        )
    return reverse_output_chain(
        x, net_spec.output_processing,
        [{k: lift(v) for k, v in p.items()} for p in params["process_outputs"]],
    )


def _stacked_loss(net_spec: NetSpec, params, feats, labels, lead: int = 1):
    """:func:`_loss_fn` of each stacked net (see :func:`_stacked_apply`)
    on its batch -> ``[*stack]``."""
    preds = _stacked_apply(net_spec, params, feats, lead)[..., 0]
    return torch.mean((preds - labels) ** 2, dim=-1)


def _stacked_step(net_spec: NetSpec, lr: float, params, opt_state, feats, labels):
    values, grads = _value_and_grads(
        lambda layers: _stacked_loss(net_spec, dict(params, layers=layers), feats, labels),
        params["layers"],
    )
    layers, opt_state = _adam_update(params["layers"], grads, opt_state, lr)
    return dict(params, layers=layers), opt_state, values


def _make_restart_epoch(
    net_spec: NetSpec,
    lr: float,
    mesh: Mesh | None = None,
    data_axis: str = "data",
):
    """One EPOCH (or a chunk of epochs) of K stacked weight inits sharing
    every batch: ``epoch(params, opt_state, feats, labels, idx) -> (params,
    opt_state, values [S, K])``, with ``feats [n, D]`` and ``labels [n]``
    resident on the device and ``idx [S, bs]`` an int32 tensor there. Each
    row of ``idx`` is one step: its batch is gathered on the device, and
    every step is dispatched from Python.

    With ``mesh`` (one-dimensional: its axis is the data axis, whatever
    ``data_axis``, which the JAX signature names, says), each step's batch
    columns split over the shards; each shard gathers its rows from its own
    replica of the features (a copy per device of the mesh, made once per
    call; shards on one device share it) and computes its gradients on its
    own stream; gradients and losses are averaged in shard order and one
    update is applied on shard 0's device, where the parameters live.
    """

    def epoch(params, opt_state, feats, labels, idx):
        values = []
        if mesh is None:
            for idx_s in idx:
                params, opt_state, v = _stacked_step(
                    net_spec, lr, params, opt_state,
                    feats.index_select(0, idx_s), labels.index_select(0, idx_s),
                )
                values.append(v)
            return params, opt_state, torch.stack(values)

        shards = len(mesh.devices)
        local = idx.shape[1] // shards
        replicas = {dev: (feats.to(dev), labels.to(dev)) for dev in set(mesh.devices)}
        for idx_s in idx:
            def body(i, dev, idx_s=idx_s):
                f, l = replicas[dev]
                cols = idx_s[i * local : (i + 1) * local].to(dev)
                mine = _tree_map(lambda t: t.to(dev), params)
                return _value_and_grads(
                    lambda layers: _stacked_loss(
                        net_spec, dict(mine, layers=layers),
                        f.index_select(0, cols), l.index_select(0, cols),
                    ),
                    mine["layers"],
                )

            parts = _on_shards(mesh, body)
            v = _psum(mesh, [p[0] for p in parts]) / shards
            grads = [
                {k: _psum(mesh, [p[1][j][k] for p in parts]) / shards for k in layer}
                for j, layer in enumerate(params["layers"])
            ]
            layers, opt_state = _adam_update(params["layers"], grads, opt_state, lr)
            params = dict(params, layers=layers)
            values.append(v)
        return params, opt_state, torch.stack(values)

    return epoch


def _save_train_state(directory: str, epoch: int, params, opt_state) -> None:
    from syllable_detector_tpu_torch.training.checkpoint import save_checkpoint

    save_checkpoint(directory, epoch, {"params": params, "opt_state": opt_state})


def _maybe_resume(directory: str, params, opt_state):
    """Restore (params, opt_state, epochs_completed) from the latest
    checkpoint in ``directory`` (into the live state's structure, devices
    and dtypes), or return the inputs unchanged with epoch 0."""
    from syllable_detector_tpu_torch.training.checkpoint import (
        latest_step,
        restore_checkpoint,
    )

    step = latest_step(directory)
    if step is None:
        return params, opt_state, 0
    state = restore_checkpoint(
        directory, step, template={"params": params, "opt_state": opt_state}
    )
    return state["params"], state["opt_state"], step


def _check_fingerprint(directory: str, fingerprint: dict) -> None:
    """Claim a checkpoint directory for THIS training configuration.

    A checkpoint is only a valid resume point for the run that produced
    it: silently adopting a stale directory (different data, seed,
    geometry, or single-vs-ensemble mode) would train a chimera while
    claiming a bit-exact resume. The fingerprint (everything defining the
    batch sequence except ``epochs`` — extending a finished run IS the
    legit use) is stored as JSON on first use and must match afterwards.
    """
    fingerprint = json.loads(json.dumps(fingerprint))  # normalize tuples
    path = os.path.join(directory, "fingerprint.json")
    if os.path.exists(path):
        try:
            with open(path) as fh:
                saved = json.load(fh)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"checkpoint directory {directory!r} has an unreadable "
                f"fingerprint.json ({e}); the directory predates this run "
                f"or was corrupted — use a fresh directory"
            ) from e
        if saved != fingerprint:
            diff = {
                k: (saved.get(k), fingerprint.get(k))
                for k in set(saved) | set(fingerprint)
                if saved.get(k) != fingerprint.get(k)
            }
            raise ValueError(
                f"checkpoint directory {directory!r} belongs to a different "
                f"training run (mismatched {sorted(diff)}); use a fresh "
                f"directory"
            )
    else:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(fingerprint, fh)
        os.replace(tmp, path)  # atomic: a crash mid-write can't brick the dir


def _data_fingerprint(features: np.ndarray, labels: np.ndarray) -> list:
    """Order-sensitive, copy-free content fingerprint of one channel's
    (features, labels). Plain float64 sums catch value changes;
    row-index-weighted sums catch reorderings and label flips that leave
    the totals unchanged. No float64 copy of the data is materialized: the
    per-row reduction and the dot run in float64 accumulators over the
    float32 rows."""
    rows = np.sum(features, axis=1, dtype=np.float64)  # [n]
    w = np.arange(1.0, len(rows) + 1.0)
    labs = np.asarray(labels, np.float64)
    return [
        float(rows.sum()),
        float(np.dot(rows, w)),
        float(labs.sum()),
        float(np.dot(labs, w)),
    ]


def _save_rng_state(directory: str, epoch: int, rngs: list) -> None:
    """Persist the epoch rngs' bit-generator states next to the checkpoint
    step so resume is O(1) instead of re-drawing every completed epoch's
    index tensor."""
    path = os.path.join(directory, f"rng_{epoch:08d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump([r.bit_generator.state for r in rngs], fh)
    os.replace(tmp, path)  # atomic: readers only ever see a complete file


def _restore_rng_state(directory: str, epoch: int, rngs: list) -> bool:
    """Restore the rng states saved at ``epoch``; False (caller falls back
    to draw-and-discard fast-forward) if absent or mismatched."""
    path = os.path.join(directory, f"rng_{epoch:08d}.json")
    if not os.path.exists(path):
        return False
    try:
        with open(path) as fh:
            states = json.load(fh)
    except (OSError, ValueError):
        # corrupt/unreadable sidecar: the draw-and-discard fast-forward
        # reproduces the exact same states, just slower — never abort
        return False
    if len(states) != len(rngs):
        return False
    for r, s in zip(rngs, states):
        r.bit_generator.state = s
    return True


# stacked per-epoch index tensors are capped at this size per upload
# (keeps host and device index memory bounded on huge datasets)
_INDEX_BUDGET_BYTES = 64 << 20


def _run_training_loop(
    settings: TrainSettings,
    epoch_fn,
    data: tuple,
    epoch_indices,
    params,
    opt_state,
    verbose: bool,
    checkpoint_dir: str | None,
    checkpoint_every: int,
    print_fn,
    fingerprint: dict,
    rngs: list,
):
    """The shared epoch loop of train()/train_ensemble().

    As many epochs as possible run per ``epoch_fn`` call (their [S, ...]
    index tensors concatenate into one upload; the batch sequence is
    identical however the epochs are chunked), bounded by the verbose print
    cadence (1), the checkpoint interval, and ``_INDEX_BUDGET_BYTES``.
    ``rngs`` are the generators ``epoch_indices`` draws from: their states
    checkpoint alongside the step for O(1) resume, with draw-and-discard
    fast-forward (``epoch_indices()`` without using the result) as the
    fallback when the rng sidecar is missing.
    """
    if checkpoint_dir is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    start_epoch = 0
    if checkpoint_dir is not None:
        _check_fingerprint(checkpoint_dir, fingerprint)
        params, opt_state, start_epoch = _maybe_resume(
            checkpoint_dir, params, opt_state
        )
        if start_epoch > settings.epochs:
            raise ValueError(
                f"checkpoint at epoch {start_epoch} is beyond "
                f"settings.epochs={settings.epochs}; raise epochs to "
                f"continue or use a fresh directory"
            )
        if start_epoch and not _restore_rng_state(
            checkpoint_dir, start_epoch, rngs
        ):
            for _ in range(start_epoch):  # fast-forward the epoch rng
                epoch_indices()
        if verbose and start_epoch:
            print(f"resumed from checkpoint at epoch {start_epoch}")

    device = data[0].device
    epoch = start_epoch
    cap = None  # epochs per call under the index budget (lazy: needs one draw)
    while epoch < settings.epochs:
        first = epoch_indices()
        if cap is None:
            cap = max(1, _INDEX_BUDGET_BYTES // max(1, first.nbytes))
        k = 1 if verbose else min(cap, settings.epochs - epoch)
        if checkpoint_dir is not None:
            k = min(k, checkpoint_every - epoch % checkpoint_every)
        idx = (
            np.concatenate([first] + [epoch_indices() for _ in range(k - 1)])
            if k > 1
            else first
        )
        params, opt_state, values = epoch_fn(
            params, opt_state, *data, torch.as_tensor(idx, dtype=torch.int32, device=device)
        )
        epoch += k
        if verbose and (
            (epoch - 1) % 25 == 0 or epoch == settings.epochs
        ):
            print_fn(epoch - 1, values)
        if checkpoint_dir is not None and (
            epoch % checkpoint_every == 0 or epoch == settings.epochs
        ):
            _save_train_state(checkpoint_dir, epoch, params, opt_state)
            _save_rng_state(checkpoint_dir, epoch, rngs)
    return params, opt_state


def _output_mapminmax() -> ProcessingSpec:
    """The exported output mapping: mapminmax with gain 2 and yMin -1, which
    maps the net's [-1, 1] range to [0, 1] probabilities."""
    return ProcessingSpec(
        name="mapminmax",
        x_offsets=np.zeros(1, np.float32),
        gains=np.full(1, 2.0, np.float32),
        y_offset=-1.0,
    )


def train(
    settings: TrainSettings,
    features: np.ndarray,
    labels: np.ndarray,
    mesh: Mesh | None = None,
    verbose: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    device="cuda",
):
    """Full training loop -> (net_spec, params, threshold).

    The output mapminmax (gain 2, yMin -1) maps net outputs from [-1, 1] to
    [0, 1] probabilities, like MATLAB's exported nets, so training fits
    apply_net's post-chain output directly to the 0/1 labels.
    ``settings.n_init`` independent weight inits (drawn in turn from one
    ``torch.Generator`` seeded with ``settings.seed``) train side by side
    and the best by full-data loss is kept. The detection threshold
    maximizes Youden's J over a grid of score quantiles
    (:func:`_pick_threshold`). The batch order is NumPy's
    ``default_rng(settings.seed)``, the JAX package's.

    Everything lives on ``device``; with ``mesh`` (its first axis is the
    data axis), on the mesh's shard 0 device, and batches split over the
    shards with gradients averaged. With ``checkpoint_dir``, (params,
    opt_state) checkpoint every ``checkpoint_every`` epochs and an
    interrupted run RESUMES from the latest checkpoint exactly as the
    uninterrupted run would have continued. The directory is fingerprinted
    to the run's configuration and data; reusing it for another run raises.
    """
    if len(features) == 0:
        raise ValueError("features has no rows")
    device = mesh.devices[0] if mesh is not None else _device(device)
    net_spec = _build_net_spec(settings)
    in_specs, _ = fit_input_chain(settings, features, device)
    _, in_params = specs_to_chain(in_specs, device)
    _, out_params = specs_to_chain([_output_mapminmax()], device)

    generator = torch.Generator().manual_seed(settings.seed)
    sizes = [settings.n_features, *settings.hidden, 1]
    K = max(1, settings.n_init)
    params = stack_params(
        [
            {
                "layers": init_layer_params(generator, sizes, device=device),
                "process_inputs": in_params,
                "process_outputs": out_params,
            }
            for _ in range(K)
        ]
    )
    opt_state = _adam_init(params["layers"], (K,))  # per-init state

    n = len(features)
    feats = torch.tensor(np.asarray(features, np.float32), device=device)
    labs = torch.tensor(np.asarray(labels, np.float32), device=device)
    bs = min(settings.batch_size, n)
    if mesh is not None:
        n_dev = len(mesh.devices)
        if n < n_dev:
            raise ValueError(
                f"{n} feature rows cannot shard over {n_dev} devices; "
                f"use a smaller mesh or more data"
            )
        bs = (bs // n_dev) * n_dev or n_dev
    epoch_fn = _make_restart_epoch(
        net_spec,
        settings.learning_rate,
        mesh=mesh,
        data_axis=mesh.axis_names[0] if mesh is not None else "data",
    )
    steps = n // bs  # one epoch = this many steps

    rng = np.random.default_rng(settings.seed)

    def epoch_indices():
        return (
            rng.permutation(n)[: steps * bs].reshape(steps, bs)
            .astype(np.int32)
        )

    fingerprint = {
        "mode": "single",
        "settings": {
            k: v for k, v in asdict(settings).items() if k != "epochs"
        },
        "n": int(n),
        "bs": int(bs),
        "mesh": list(mesh.shape.items()) if mesh is not None else None,
        "data": _data_fingerprint(features, labels),
    }

    def print_fn(epoch, values):
        print(
            f"epoch {epoch}: loss {_host(values).mean(0).min():.5f} "
            f"(best of {K} inits)"
        )

    params, opt_state = _run_training_loop(
        settings, epoch_fn, (feats, labs), epoch_indices, params, opt_state,
        verbose, checkpoint_dir, checkpoint_every, print_fn, fingerprint,
        [rng],
    )

    with torch.no_grad():
        full = _host(_stacked_loss(net_spec, params, feats, labs))
        best = int(np.argmin(full))
        params = _tree_map(lambda x: x[best], params)
        preds = _host(apply_net(net_spec, params, feats)[..., 0])
    threshold = _pick_threshold(preds, labels)
    return net_spec, params, threshold


def make_ensemble_epoch(
    net_spec: NetSpec,
    lr: float,
    n_init: int = 1,
    mesh: Mesh | None = None,
    channel_axis: str = "channel",
):
    """One EPOCH (or a chunk of epochs) of a CHANNEL-STACKED ensemble of
    independent nets: ``epoch(params, opt_state, feats_all, labs_all, idx)
    -> (params, opt_state, values [S, C*K])`` with ``feats_all [C, n_max,
    D]`` and ``labs_all [C, n_max]`` resident on the device and ``idx [S, C,
    bs]`` an int32 tensor there; each step gathers every channel's batch
    rows on the device.

    The parameters carry a flat leading ``C * n_init`` axis on every
    tensor (channel-major: flat index ``c*K + k``); every init of a
    channel shares the channel's batch (broadcast over the init axis, so no
    K-fold batch copy exists). Adam is elementwise, so updating the stack is
    exactly C*K independent optimizers. With ``mesh``, the channels split
    over the ``channel_axis`` shards, each shard training its whole
    channels (all K inits together) through the whole call on its own
    stream, with no communication between shards.
    """
    K = max(1, n_init)

    def local_epoch(params, opt_state, feats_all, labs_all, idx):
        c, n_max = labs_all.shape
        flat_feats = feats_all.reshape(c * n_max, feats_all.shape[2])
        flat_labs = labs_all.reshape(c * n_max)
        offsets = (torch.arange(c, device=idx.device) * n_max)[:, None]

        def loss(layers, fb, lb):
            folded = _tree_map(
                lambda x: x.reshape(c, K, *x.shape[1:]), dict(params, layers=layers)
            )
            # every init of a channel broadcasts over the channel's batch
            return _stacked_loss(net_spec, folded, fb[:, None], lb[:, None], lead=2).reshape(-1)

        values = []
        for idx_s in idx:
            rows = (idx_s + offsets).reshape(-1)
            fb = flat_feats.index_select(0, rows).reshape(c, -1, flat_feats.shape[1])
            lb = flat_labs.index_select(0, rows).reshape(c, -1)
            v, grads = _value_and_grads(lambda layers: loss(layers, fb, lb), params["layers"])
            layers, opt_state = _adam_update(params["layers"], grads, opt_state, lr)
            params = dict(params, layers=layers)
            values.append(v)
        return params, opt_state, torch.stack(values)

    if mesh is None:
        return local_epoch

    def epoch(params, opt_state, feats_all, labs_all, idx):
        shards = int(mesh.shape[channel_axis])
        per = labs_all.shape[0] // shards

        def body(i, dev):
            nets = slice(i * per * K, (i + 1) * per * K)
            chans = slice(i * per, (i + 1) * per)
            return local_epoch(
                _tree_map(lambda t: t[nets].to(dev), params),
                _tree_map(lambda t: t[nets].to(dev), opt_state),
                feats_all[chans].to(dev),
                labs_all[chans].to(dev),
                idx[:, chans].to(dev),
            )

        parts = _on_shards(mesh, body)
        return (
            _gather(mesh, [p[0] for p in parts]),
            tuple(_gather(mesh, [p[1] for p in parts])),
            torch.cat([p[2].to(mesh.devices[0]) for p in parts], dim=1),
        )

    return epoch


def train_ensemble(
    settings: TrainSettings,
    features_list: list[np.ndarray],
    labels_list: list[np.ndarray],
    mesh: Mesh | None = None,
    channel_axis: str = "channel",
    verbose: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    device="cuda",
):
    """Train C independent per-channel nets together ->
    (net_spec, [params_c], [threshold_c]).

    Every channel gets its own input-chain fit, weight inits
    (``settings.n_init`` restarts per channel, drawn in turn, channel-major,
    from one ``torch.Generator`` seeded with ``settings.seed``; best by
    full-data loss), batch sampling (NumPy's ``default_rng(seed + c)``, the
    JAX package's) and Youden-J threshold; geometry (``settings``) is
    shared. An epoch covers the LONGEST channel once; channels with fewer
    evaluations wrap their batch sampling (mod their own length), and the
    padded rows of the ``[C, n_max, D]`` feature stack are never indexed.
    With ``mesh``, C must divide evenly over the ``channel_axis`` shards
    (every shard holds whole channels — all n_init inits together).
    ``checkpoint_dir``/``checkpoint_every`` behave as in :func:`train`.
    """
    C = len(features_list)
    K = max(1, settings.n_init)
    if C == 0 or len(labels_list) != C:
        raise ValueError("features_list and labels_list must pair one-to-one")
    for c, f in enumerate(features_list):
        if len(f) == 0:
            raise ValueError(f"channel {c} has no feature rows")
    if mesh is not None:
        n_dev = int(np.prod([mesh.shape[a] for a in (channel_axis,)]))
        if C % n_dev:
            raise ValueError(
                f"{C} channels do not shard evenly over "
                f"{n_dev} '{channel_axis}' devices"
            )
    device = mesh.devices[0] if mesh is not None else _device(device)
    net_spec = _build_net_spec(settings)
    _, out_params = specs_to_chain([_output_mapminmax()], device)
    sizes = [settings.n_features, *settings.hidden, 1]
    generator = torch.Generator().manual_seed(settings.seed)
    per_params = []
    for c in range(C):
        if features_list[c].shape[1] != settings.n_features:
            raise ValueError(
                f"channel {c} features have {features_list[c].shape[1]} "
                f"columns, settings expect {settings.n_features}"
            )
        _, in_params = specs_to_chain(
            fit_input_chain(settings, features_list[c], device)[0], device
        )
        for _ in range(K):  # flat stack index = c * K + k (channel-major)
            per_params.append(
                {
                    "layers": init_layer_params(generator, sizes, device=device),
                    "process_inputs": in_params,
                    "process_outputs": out_params,
                }
            )
    params = stack_params(per_params)
    opt_state = _adam_init(params["layers"], (C * K,))  # per-init state
    epoch_fn = make_ensemble_epoch(
        net_spec,
        settings.learning_rate,
        n_init=K,
        mesh=mesh,
        channel_axis=channel_axis,
    )

    ns = [len(f) for f in features_list]
    bs = min(settings.batch_size, min(ns))
    # an epoch covers the LONGEST channel once; shorter channels wrap
    steps_per_epoch = max(1, max(ns) // bs)
    n_max = max(ns)
    feats_all = torch.zeros((C, n_max, settings.n_features), dtype=torch.float32, device=device)
    labs_all = torch.zeros((C, n_max), dtype=torch.float32, device=device)
    for c in range(C):
        feats_all[c, : ns[c]] = torch.tensor(
            np.asarray(features_list[c], np.float32), device=device
        )
        labs_all[c, : ns[c]] = torch.tensor(
            np.asarray(labels_list[c], np.float32), device=device
        )

    rngs = [np.random.default_rng(settings.seed + c) for c in range(C)]

    def epoch_indices():
        orders = [r.permutation(n) for r, n in zip(rngs, ns)]
        return np.stack(
            [
                np.take(
                    orders[c],
                    np.arange(steps_per_epoch * bs),
                    mode="wrap",
                ).reshape(steps_per_epoch, bs)
                for c in range(C)
            ],
            axis=1,
        ).astype(np.int32)  # [S, C, bs]

    fingerprint = {
        "mode": "ensemble",
        "settings": {
            k: v for k, v in asdict(settings).items() if k != "epochs"
        },
        "ns": [int(n) for n in ns],
        "bs": int(bs),
        "mesh": list(mesh.shape.items()) if mesh is not None else None,
        "data": [
            _data_fingerprint(f, l)
            for f, l in zip(features_list, labels_list)
        ],
    }

    def print_fn(epoch, values):
        mean = _host(values).mean(axis=0).reshape(C, K)
        print(
            f"epoch {epoch}: loss "
            + " ".join(f"{v:.5f}" for v in mean.min(axis=1))
            + (f" (best of {K} inits)" if K > 1 else "")
        )

    params, opt_state = _run_training_loop(
        settings, epoch_fn, (feats_all, labs_all), epoch_indices, params,
        opt_state, verbose, checkpoint_dir, checkpoint_every, print_fn,
        fingerprint, rngs,
    )

    # best init per channel by full-data loss over each channel's true
    # prefix of the padded stack
    params_list, thresholds = [], []
    with torch.no_grad():
        for c in range(C):
            mine = _tree_map(lambda x: x[c * K : (c + 1) * K], params)
            full = _host(
                _stacked_loss(net_spec, mine, feats_all[c, : ns[c]], labs_all[c, : ns[c]])
            )
            params_c = _tree_map(lambda x: x[int(np.argmin(full))], mine)
            preds = _host(apply_net(net_spec, params_c, feats_all[c, : ns[c]])[..., 0])
            params_list.append(params_c)
            thresholds.append(_pick_threshold(preds, labels_list[c]))
    return net_spec, params_list, thresholds


def _pick_threshold(preds: np.ndarray, labels: np.ndarray) -> float:
    """Maximize Youden's J (recall - false-alarm rate) over a score grid —
    robust to label noise at syllable boundaries."""
    pos = preds[labels > 0.5]
    neg = preds[labels < 0.5]
    if not len(pos) or not len(neg):
        return 0.5
    candidates = np.unique(np.quantile(preds, np.linspace(0.01, 0.99, 197)))
    best_t, best_j = 0.5, -np.inf
    for t in candidates:
        j = (pos >= t).mean() - (neg >= t).mean()
        if j > best_j:
            best_j, best_t = j, float(t)
    return min(max(best_t, 1e-3), 0.999)


def export_trained_config(
    settings: TrainSettings, net_spec: NetSpec, params, threshold: float
) -> SyllableDetectorConfig:
    """Package trained parameters (tensors on any device, or numpy) into a
    SyllableDetectorConfig (the convert_to_text.m equivalent; save with
    config.save_config)."""
    layers = []
    for (inputs, outputs), transfer, lp in zip(
        net_spec.layer_sizes, net_spec.transfers, params["layers"]
    ):
        layers.append(
            LayerSpec(
                inputs=inputs,
                outputs=outputs,
                weights=_host(lp["w"]).astype(np.float32),
                biases=_host(lp["b"]).astype(np.float32),
                transfer=transfer,
            )
        )
    process_inputs = []
    for name, p in zip(net_spec.input_processing, params["process_inputs"]):
        if name not in ("mapminmax", "mapstd"):  # parameter-free stages
            process_inputs.append(ProcessingSpec(name))
        else:
            process_inputs.append(
                ProcessingSpec(
                    name,
                    x_offsets=_host(p["x_offsets"]).astype(np.float32),
                    gains=_host(p["gains"]).astype(np.float32),
                    y_offset=float(p["y_offset"]),
                )
            )
    process_outputs = [
        ProcessingSpec(
            "mapminmax",
            x_offsets=_host(p["x_offsets"]).astype(np.float32),
            gains=_host(p["gains"]).astype(np.float32),
            y_offset=float(p["y_offset"]),
        )
        for name, p in zip(net_spec.output_processing, params["process_outputs"])
    ]
    return SyllableDetectorConfig(
        sampling_rate=settings.sampling_rate,
        fourier_length=settings.fourier_length,
        window_length=settings.window_length,
        window_overlap=settings.window_overlap,
        freq_range=settings.freq_range,
        time_range=settings.time_range,
        thresholds=[threshold],
        scaling=settings.scaling,
        layers=layers,
        process_inputs=process_inputs,
        process_outputs=process_outputs,
    )
