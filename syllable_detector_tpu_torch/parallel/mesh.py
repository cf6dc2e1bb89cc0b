"""Mesh-sharded multi-channel detection on torch devices.

Counterpart of ``syllable_detector_tpu.parallel.mesh``. There a mesh is one
process driving its local devices and every sharded function is a
``shard_map`` of a per-shard body; here a :class:`Mesh` is a tuple of
``torch.device`` objects, one per shard, and each sharded function splits its
inputs per shard, runs the per-shard body on that shard's device, on a CUDA
stream of its own, and joins the results on shard 0's device:

  * ``P(axis)`` outputs are concatenated there in shard order;
  * ``psum`` becomes: the partials are copied there and added in shard
    order, so the sum is deterministic;
  * ``ppermute`` of the time-sharded halo becomes: shard i reads the first
    ``halo`` samples of shard i+1's segment (a device-to-device copy), and
    the last shard takes the stream tail.

Shards may outnumber the devices (:func:`make_mesh` lays them round-robin),
so one card can carry a 4-shard mesh whose shards overlap on their streams.
Stream order is explicit: a shard's stream first waits for the stream its
inputs were produced on, and the caller's stream waits for every shard
before it reads a result (``wait_stream`` / ``record_stream``); the halo is
read in a second pass, after every segment has been placed.

The JAX module's memo of jitted callables has no counterpart (PyTorch runs
eagerly); only the numpy constant fold of the tensor-sharded form is kept
per (spec, params, mesh size).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from syllable_detector_tpu_torch.models.detector import (
    WINDOW,
    DetectorSpec,
    offline_outputs,
    streaming_step,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_offline_outputs",
    "sharded_offline_outputs",
    "sharded_fused_offline_outputs",
    "sharded_detection_counts",
    "sharded_streaming_step",
    "time_sharded_offline_outputs",
    "tensor_sharded_offline_outputs",
]

CHANNEL_AXIS = "channel"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard i runs on ``devices[i]`` (a device may carry
    several shards)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (CHANNEL_AXIS,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    def __str__(self) -> str:
        return f"{len(self.devices)} shard(s) on {', '.join(str(d) for d in self.devices)}"


def make_mesh(
    n_shards: int | None = None, axis: str = CHANNEL_AXIS, devices=None
) -> Mesh:
    """1-D mesh of ``n_shards`` shards over ``devices`` (default: every
    visible CUDA device; pass CPU devices to run on the CPU). By default
    there is one shard per device. More shards than devices are laid
    round-robin over them (shard i on ``devices[i % len(devices)]``), so one
    card can carry several shards; fewer take the first devices."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "no CUDA device is visible (pass devices=[torch.device('cpu')] "
                "to build a mesh on the CPU)"
            )
    devices = [torch.device(d) for d in devices]
    if n_shards is None:
        n_shards = len(devices)
    if n_shards < 1 or not devices:
        raise ValueError("a mesh needs at least one shard and one device")
    return Mesh(tuple(devices[i % len(devices)] for i in range(n_shards)), (axis,))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@functools.cache
def _shard_stream(device: torch.device, index: int) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


def _on_shards(mesh: Mesh, body) -> list:
    """``[body(i, device) for each shard]``. On a CUDA device the body runs
    on the shard's own stream, which first waits for the device's current
    stream (where the inputs were produced); before returning, each
    device's current stream waits for its shards, and the results are
    recorded on it, so the caller may use them as any other tensor."""
    results, side = [], []
    for i, dev in enumerate(mesh.devices):
        if dev.type != "cuda":
            results.append(body(i, dev))
            continue
        main = torch.cuda.current_stream(dev)
        stream = _shard_stream(dev, i)
        stream.wait_stream(main)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            results.append(body(i, dev))
        side.append((main, stream, results[-1]))
    for main, stream, result in side:
        main.wait_stream(stream)
        for t in _leaves(result):
            t.record_stream(main)
    return results


def _size(mesh: Mesh) -> int:
    return int(mesh.shape[mesh.axis_names[0]])


def _local(mesh: Mesh, c: int):
    """``i -> slice`` of shard i's channels; C must divide by the mesh."""
    d = _size(mesh)
    if c % d != 0:
        raise ValueError(f"channels {c} must divide by mesh size {d}")
    per = c // d
    return lambda i: slice(i * per, (i + 1) * per)


def _gather(mesh: Mesh, parts: list):
    """Shard outputs joined along the channel axis on shard 0's device."""
    dev0 = mesh.devices[0]
    first = parts[0]
    if isinstance(first, dict):
        return {k: _gather(mesh, [p[k] for p in parts]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_gather(mesh, [p[i] for p in parts]) for i in range(len(first))]
    return torch.cat([p.to(dev0) for p in parts])


def _psum(mesh: Mesh, parts: list) -> torch.Tensor:
    """The partials added on shard 0's device, in shard order."""
    dev0 = mesh.devices[0]
    total = parts[0].to(dev0)
    for p in parts[1:]:
        total = total + p.to(dev0)
    return total


def batch_offline_outputs(
    spec: DetectorSpec, stacked_params, xs: torch.Tensor, method: str = "matmul"
) -> torch.Tensor:
    """[C, n] streams + stacked per-channel params -> [C, E, outputs]."""
    return torch.func.vmap(lambda p, x: offline_outputs(spec, p, x, method=method))(
        stacked_params, xs
    )


def sharded_offline_outputs(
    mesh: Mesh,
    spec: DetectorSpec,
    stacked_params,
    xs: torch.Tensor,
    method: str = "matmul",
) -> torch.Tensor:
    """Shard the channel axis across the mesh; each shard runs its local
    channels with no communication between shards."""
    local = _local(mesh, xs.shape[0])

    def body(i, dev):
        params = _tree_map(lambda t: t[local(i)].to(dev), stacked_params)
        return batch_offline_outputs(spec, params, xs[local(i)].to(dev), method=method)

    return _gather(mesh, _on_shards(mesh, body))


def sharded_fused_offline_outputs(
    mesh: Mesh,
    spec: DetectorSpec,
    params,
    xs: torch.Tensor,
    tile: int | None = None,
    n_evals: int | None = None,
    slab_channels: int | None = 64,
    layout: str = "flat",
) -> torch.Tensor:
    """Channel-sharded detection on the fused kernel: [C, n] streams ->
    [C, E, outputs] with the channel axis split across the mesh and each
    shard running its local channels through the batched fused kernel
    (``layout="flat"``: one launch; ``"grid"``: one per slab of
    ``slab_channels`` lanes).

    ``params`` is ONE shared net (dict, folded once per device) or C
    DISTINCT per-channel nets (sequence, each shard folding its own). C
    must divide by the mesh size (pad channels and slice, as scan_corpus
    does). ``tile`` is the kernels' own choice and is ignored.
    """
    from syllable_detector_tpu_torch.kernels.fused_detector import (
        fold_constants,
        fold_constants_stacked,
        fusable,
        fused_batch_offline_outputs,
    )
    from syllable_detector_tpu_torch.models.neural_net import stack_params
    from syllable_detector_tpu_torch.ops.stft import num_frames

    c, n = xs.shape
    local = _local(mesh, c)
    distinct = isinstance(params, (list, tuple))
    if distinct and len(params) != c:
        raise ValueError(f"{len(params)} per-channel networks for {c} channels")
    if not fusable(spec):
        plist = list(params) if distinct else [params] * c
        return sharded_offline_outputs(mesh, spec, stack_params(plist), xs)

    f = num_frames(n, spec.window_length, spec.window_overlap)
    max_evals = f - spec.time_range + 1
    if n_evals is None:
        n_evals = max_evals
    elif n_evals > max_evals:
        raise ValueError(f"n_evals={n_evals} needs more than {n} samples")
    if n_evals <= 0:
        return xs.new_zeros((c, 0, spec.net.outputs), dtype=torch.float32)

    shared = {}  # one fold of the shared net per device

    def body(i, dev):
        if distinct:
            mine = list(params[local(i)])
            folded = fold_constants_stacked(spec, mine, dev)
        else:
            mine = params
            if dev not in shared:
                shared[dev] = fold_constants(spec, params, dev)
            folded = shared[dev]
        return fused_batch_offline_outputs(
            spec, mine, xs[local(i)].to(dev), n_evals=n_evals,
            slab_channels=slab_channels, layout=layout, folded=folded,
        )

    return _gather(mesh, _on_shards(mesh, body))


def sharded_detection_counts(
    mesh: Mesh, spec: DetectorSpec, stacked_params, xs: torch.Tensor
) -> torch.Tensor:
    """Global detection count per output: each shard counts its channels'
    outputs at or above the thresholds, and the counts are summed across
    the mesh (int32 [outputs])."""
    local = _local(mesh, xs.shape[0])

    def body(i, dev):
        params = _tree_map(lambda t: t[local(i)].to(dev), stacked_params)
        outs = batch_offline_outputs(spec, params, xs[local(i)].to(dev))
        thresholds = torch.tensor(spec.thresholds, dtype=torch.float32, device=dev)
        return torch.sum(outs >= thresholds, dim=(0, 1)).to(torch.int32)

    return _psum(mesh, _on_shards(mesh, body))


# the numpy constant folds of tensor_sharded_offline_outputs, per (spec,
# params, mesh size); bounded LRU whose values hold a strong params
# reference, so an id cannot be recycled
_tp_const_cache: OrderedDict = OrderedDict()
_TP_CACHE_MAX = 32


def _tp_constants(spec: DetectorSpec, params, d: int):
    """Shard-stacked constants of tensor_sharded_offline_outputs (a numpy
    fold, the JAX package's)."""
    from syllable_detector_tpu_torch.ops.processing import (
        fold_input_affines,
        fold_output_affines,
    )
    from syllable_detector_tpu_torch.ops.stft import band_dft_matrices

    def host(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    b = spec.n_bins
    t_range = spec.time_range
    bp = -(-b // d)  # bins per shard (zero-padded shards)

    c_re, c_im = band_dft_matrices(
        spec.fourier_length, spec.window_length, WINDOW, spec.bins
    )
    c_re_p = np.zeros((spec.window_length, d * bp), np.float32)
    c_im_p = np.zeros((spec.window_length, d * bp), np.float32)
    c_re_p[:, :b] = c_re
    c_im_p[:, :b] = c_im
    c_re_s = np.stack(np.split(c_re_p, d, axis=1))  # [d, window, bp]
    c_im_s = np.stack(np.split(c_im_p, d, axis=1))

    scale, shift, has_l2 = fold_input_affines(
        spec.net.input_processing, params["process_inputs"], t_range * b
    )
    w1 = host(params["layers"][0]["w"], np.float64)  # [H, D_feats]
    h1 = w1.shape[0]
    w1_eff = w1 * scale[None, :]
    b_eff = host(params["layers"][0]["b"], np.float64) + w1 @ shift

    # local W1 columns: shard dd owns features (t, dd*bp + j) for all t
    w1_s = np.zeros((d, t_range * bp, h1), np.float32)
    for dd in range(d):
        for j in range(min(bp, b - dd * bp)):
            gbin = dd * bp + j
            for t in range(t_range):
                w1_s[dd, t * bp + j, :] = w1_eff[:, t * b + gbin]
    mask = np.zeros((d, bp), np.float32)
    for dd in range(d):
        mask[dd, : max(0, min(bp, b - dd * bp))] = 1.0

    mids = [
        (host(layer["w"], np.float32).T, host(layer["b"], np.float32))
        for layer in params["layers"][1:]
    ]
    out_a, out_c = fold_output_affines(
        spec.net.output_processing, params["process_outputs"], spec.net.outputs
    )
    return (
        c_re_s, c_im_s, w1_s, mask, has_l2, tuple(mids),
        out_a.astype(np.float32), out_c.astype(np.float32),
        b_eff.astype(np.float32),
    )


def tensor_sharded_offline_outputs(
    mesh: Mesh,
    spec: DetectorSpec,
    params,
    x: torch.Tensor,
) -> torch.Tensor:
    """One detector's FEATURE axis sharded across the mesh: each shard
    computes the band DFT for its share of the frequency bins (zero-padded
    to equal shares) and its columns of the affine-folded first layer; the
    partial layer-1 products and the partial l2 sums are added across the
    mesh, and everything after layer 1 (a few hundred operations) runs on
    shard 0's device.

    The algebra: with the input chain folded to ``x*scale + shift`` and
    l2normalize linear in the contraction, ``W1 @ chain(feat) =
    sum_d(W1_d' @ feat_d)/||feat|| + (b1 + W1 @ shift)``. Matches
    :func:`~syllable_detector_tpu_torch.models.detector.offline_outputs` up
    to the order of the partial sums; falls back to it for unsupported
    processing chains.
    """
    from syllable_detector_tpu_torch.kernels.fused_detector import fusable
    from syllable_detector_tpu_torch.ops.stft import (
        frame_signal,
        num_frames,
        stack_features,
    )
    from syllable_detector_tpu_torch.ops.transfer import apply_transfer

    if not fusable(spec):
        return offline_outputs(spec, params, x)

    d = _size(mesh)
    t_range = spec.time_range
    key = (spec, id(params), d)
    hit = _tp_const_cache.get(key)
    if hit is None or hit[1] is not params:
        _tp_const_cache[key] = hit = (_tp_constants(spec, params, d), params)
        while len(_tp_const_cache) > _TP_CACHE_MAX:
            _tp_const_cache.popitem(last=False)
    else:
        _tp_const_cache.move_to_end(key)
    c_re_s, c_im_s, w1_s, mask, has_l2, mids, out_a, out_c, b_eff = hit[0]

    f = num_frames(int(x.shape[0]), spec.window_length, spec.window_overlap)
    n_evals = f - t_range + 1
    if n_evals <= 0:
        return x.new_zeros((0, spec.net.outputs), dtype=torch.float32)
    scaling = spec.scaling

    def body(i, dev):
        def on(a):
            return torch.from_numpy(a).to(dev)

        frames = frame_signal(x.to(dev), f, spec.window_length, spec.window_overlap)
        re = frames @ on(c_re_s[i])
        im = frames @ on(c_im_s[i])
        mag = torch.sqrt(re * re + im * im)
        if scaling == "db":
            s = torch.where(on(mask[i]) > 0, 20.0 * torch.log10(mag), 0.0)
        elif scaling == "log":
            s = torch.where(on(mask[i]) > 0, torch.log(mag), 0.0)
        else:
            s = mag
        feats = stack_features(s, t_range)  # [E, T*bp]
        return feats @ on(w1_s[i]), torch.sum(feats * feats, dim=1, keepdim=True)

    parts = _on_shards(mesh, body)
    dev0 = mesh.devices[0]
    z = _psum(mesh, [p[0] for p in parts])
    if has_l2:
        z = z / torch.sqrt(_psum(mesh, [p[1] for p in parts]))
    transfers = spec.net.transfers
    h = apply_transfer(z + torch.from_numpy(b_eff).to(dev0), transfers[0])
    for (w, bb), name in zip(mids, transfers[1:]):
        h = apply_transfer(
            h @ torch.from_numpy(w).to(dev0) + torch.from_numpy(bb).to(dev0), name
        )
    return h * torch.from_numpy(out_a).to(dev0) + torch.from_numpy(out_c).to(dev0)


def time_sharded_offline_outputs(
    mesh: Mesh,
    spec: DetectorSpec,
    params,
    x: torch.Tensor,
    method: str = "matmul",
) -> torch.Tensor:
    """One long stream's TIME axis sharded across the mesh, the
    sequence-parallel form of this workload.

    Each shard evaluates a contiguous block of hops from its own segment
    plus a ``(timeRange-2)*hop + gap + window`` sample halo read from the
    head of its right neighbour's segment; the last shard takes the
    zero-padded stream tail instead. Numerically identical to
    :func:`~syllable_detector_tpu_torch.models.detector.offline_outputs` on
    the whole stream. ``method="fused"`` runs each segment through the fused
    kernel. The JAX function's 4 MiB guard on the net's size there protects
    its compiler from large embedded constants and has no counterpart here.
    """
    from syllable_detector_tpu_torch.ops.stft import normalize_overlap, num_frames

    d = _size(mesh)
    gap, _ = normalize_overlap(spec.window_overlap)
    hop = spec.hop
    halo = (spec.time_range - 2) * hop + gap + spec.window_length

    n = int(x.shape[0])
    f = num_frames(n, spec.window_length, spec.window_overlap)
    e_total = f - spec.time_range + 1
    if e_total <= 0:
        return x.new_zeros((0, spec.net.outputs), dtype=torch.float32)
    e_loc = -(-e_total // d)
    if e_loc * hop < halo:
        # segments shorter than the halo cannot feed their neighbour; the
        # stream is too short to be worth sharding anyway
        return offline_outputs(spec, params, x, method=method)

    body_len = d * e_loc * hop
    need = body_len + halo
    x = x.to(torch.float32)
    if need > n:
        x = torch.cat([x, x.new_zeros(need - n)])
    xs = x[:body_len].reshape(d, e_loc * hop)
    tail = x[body_len:need]  # the last shard's halo lives in the stream tail

    if method == "fused":
        from syllable_detector_tpu_torch.kernels.fused_detector import (
            fusable,
            fused_offline_outputs,
        )

        if not fusable(spec):
            method = "matmul"  # same fallback as the offline fused path

    # first pass: every segment on its shard's device. The second pass
    # starts only after the first has been joined, so a halo is never read
    # before its segment is there.
    segments = _on_shards(mesh, lambda i, dev: xs[i].to(dev))

    def body(i, dev):
        right = tail if i == d - 1 else segments[i + 1][:halo]
        seg = torch.cat([segments[i], right.to(dev)])
        mine = _tree_map(lambda t: t.to(dev), params)
        if method == "fused":
            return fused_offline_outputs(spec, mine, seg)
        return offline_outputs(spec, mine, seg, method=method)

    return _gather(mesh, _on_shards(mesh, body))[:e_total]


def sharded_streaming_step(
    mesh: Mesh,
    spec: DetectorSpec,
    stacked_params,
    carries,
    chunks: torch.Tensor,
):
    """One fixed-shape streaming step for all channels, sharded over the mesh.

    ``carries`` is the stacked streaming carry ([C, ...] leaves from
    models.detector.streaming_init); ``chunks`` is [C, H*hop]. Returns
    (new_carries, outputs [C, H, outputs]).
    """
    local = _local(mesh, chunks.shape[0])

    def body(i, dev):
        def mine(tree):
            return _tree_map(lambda t: t[local(i)].to(dev), tree)

        new, outs = torch.func.vmap(lambda p, c, x: streaming_step(spec, p, c, x))(
            mine(stacked_params), mine(carries), chunks[local(i)].to(dev)
        )
        return [new, outs]

    new_carries, outs = _gather(mesh, _on_shards(mesh, body))
    return new_carries, outs
