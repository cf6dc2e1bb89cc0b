"""The port's mesh-sharded functions (``parallel/mesh.py``) against their JAX
counterparts on JAX's 8 virtual CPU devices, with 1, 2, 4 and 8 CPU shards.

Every input comes from a numpy seed and goes through both packages; the
nets are seeded fixture nets, converted weight for weight. Tolerances: the
fp32 paths (channel-, time-sharded, streaming, detection counts) rtol=1e-4,
atol=1e-5, the port's contract against the JAX functions; the fused paths
rtol=1e-3, atol=2e-4, the fused kernel's own bound; the tensor-sharded form
adds its partial sums in another order than the unsharded path and is held
to that bound too. Sharding itself must not change a value: against the
port's own unsharded function the sharded one is held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import syllable_detector_tpu.corpus as jcorpus
from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu.models import neural_net as jnn
from syllable_detector_tpu.parallel import mesh as jmesh
from syllable_detector_tpu_torch import corpus as tcorpus
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.cli import main as port_main
from syllable_detector_tpu_torch.kernels import fused_detector as tfused
from syllable_detector_tpu_torch.models import detector as tdet
from syllable_detector_tpu_torch.models import neural_net as tnn
from syllable_detector_tpu_torch.parallel import mesh as tmesh
from test_torch_cli import run
from test_torch_fused_detector import both

torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]
LANES = 8
CPU = torch.device("cpu")


def cpu_mesh(d: int) -> tmesh.Mesh:
    return tmesh.make_mesh(d, devices=[CPU])


def close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def nets():
    """8 nets of the sample geometry, in both packages, and 8 streams."""
    audio = np.stack([fixtures.chirp_audio(0.2, 30 + i) for i in range(LANES)])
    cfgs = [
        fixtures.pick_thresholds(fixtures.sample_geometry_config(60 + i), audio.T)
        for i in range(LANES)
    ]
    quads = [both(c) for c in cfgs]
    return {
        "cfgs": cfgs,
        "tspec": quads[0][0],
        "tparams": [q[1] for q in quads],
        "jspec": quads[0][2],
        "jparams": [q[3] for q in quads],
        "xs": audio,
    }


def test_make_mesh_lays_shards_over_devices():
    mesh = tmesh.make_mesh(4, devices=["cpu"])
    assert mesh.devices == (CPU,) * 4 and mesh.axis_names == ("channel",)
    assert mesh.shape == {"channel": 4} and "4 shard(s) on cpu" in str(mesh)
    two = [torch.device("meta"), CPU]
    assert tmesh.make_mesh(devices=two).devices == tuple(two)  # one shard per device
    assert tmesh.make_mesh(3, axis="time", devices=two).devices == (two[0], two[1], two[0])
    assert tmesh.make_mesh(1, devices=two).devices == (two[0],)
    assert tmesh.make_mesh(3, axis="time", devices=two).axis_names == ("time",)
    with pytest.raises(ValueError, match="at least one shard"):
        tmesh.make_mesh(0, devices=[CPU])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
    assert len(jmesh.make_mesh(4).devices) == 4  # the JAX mesh the tests compare with


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_offline_outputs_matches_jax(nets, d):
    xs = nets["xs"]
    got = tmesh.sharded_offline_outputs(
        cpu_mesh(d), nets["tspec"], tnn.stack_params(nets["tparams"]), torch.from_numpy(xs)
    )
    want = jmesh.sharded_offline_outputs(
        jmesh.make_mesh(d), nets["jspec"], jnn.stack_params(nets["jparams"]), jnp.asarray(xs)
    )
    close(got.numpy(), want)
    whole = tmesh.batch_offline_outputs(
        nets["tspec"], tnn.stack_params(nets["tparams"]), torch.from_numpy(xs)
    )
    close(got.numpy(), whole.numpy(), 1e-6, 1e-6)
    assert not np.allclose(got[0].numpy(), got[1].numpy(), equal_nan=True)  # distinct nets


@pytest.mark.parametrize("layout,distinct", [("flat", False), ("flat", True), ("grid", True)])
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_fused_matches_jax(nets, d, layout, distinct):
    xs = nets["xs"]
    tparams = nets["tparams"] if distinct else nets["tparams"][0]
    jparams = nets["jparams"] if distinct else nets["jparams"][0]
    got = tmesh.sharded_fused_offline_outputs(
        cpu_mesh(d), nets["tspec"], tparams, torch.from_numpy(xs),
        layout=layout, slab_channels=1,
    )
    want = jmesh.sharded_fused_offline_outputs(
        jmesh.make_mesh(d), nets["jspec"], jparams, jnp.asarray(xs),
        layout=layout, slab_channels=1,
    )
    close(got.numpy(), want, 1e-3, 2e-4)
    whole = tfused.fused_batch_offline_outputs(nets["tspec"], tparams, torch.from_numpy(xs))
    close(got.numpy(), whole.numpy(), 1e-6, 1e-6)


@pytest.mark.parametrize("d", [1, 8])
def test_sharded_fused_n_evals_and_unfusable(nets, d):
    import dataclasses

    from syllable_detector_tpu.config.model_format import ProcessingSpec

    xs = torch.from_numpy(nets["xs"])
    mesh = cpu_mesh(d)
    short = tmesh.sharded_fused_offline_outputs(mesh, nets["tspec"], nets["tparams"], xs, n_evals=5)
    full = tmesh.sharded_fused_offline_outputs(mesh, nets["tspec"], nets["tparams"], xs)
    np.testing.assert_array_equal(short.numpy(), full[:, :5].numpy())
    with pytest.raises(ValueError, match="needs more than"):
        tmesh.sharded_fused_offline_outputs(mesh, nets["tspec"], nets["tparams"], xs, n_evals=10**6)
    none = tmesh.sharded_fused_offline_outputs(mesh, nets["tspec"], nets["tparams"], xs[:, :1000])
    assert none.shape == (LANES, 0, 1)
    with pytest.raises(ValueError, match="per-channel networks"):
        tmesh.sharded_fused_offline_outputs(mesh, nets["tspec"], nets["tparams"][:3], xs)
    # an unfusable chain takes the unfused sharded path, as in the JAX function
    cfg = dataclasses.replace(nets["cfgs"][0], process_inputs=[ProcessingSpec("normalize")])
    tspec, tparams, jspec, jparams = both(cfg)
    got = tmesh.sharded_fused_offline_outputs(mesh, tspec, tparams, xs)
    want = jmesh.sharded_fused_offline_outputs(
        jmesh.make_mesh(d), jspec, jparams, jnp.asarray(nets["xs"])
    )
    close(got.numpy(), want)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_detection_counts_match_jax(nets, d):
    xs = nets["xs"]
    got = tmesh.sharded_detection_counts(
        cpu_mesh(d), nets["tspec"], tnn.stack_params(nets["tparams"]), torch.from_numpy(xs)
    )
    want = jmesh.sharded_detection_counts(
        jmesh.make_mesh(d), nets["jspec"], jnn.stack_params(nets["jparams"]), jnp.asarray(xs)
    )
    assert got.dtype == torch.int32 and got.shape == (1,)
    # the spec's thresholds sit 1e-3 from every output, so no count can flip
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    outs = tmesh.batch_offline_outputs(
        nets["tspec"], tnn.stack_params(nets["tparams"]), torch.from_numpy(xs)
    ).numpy()
    assert 0 < int(got[0]) == int((outs >= np.float32(nets["tspec"].thresholds[0])).sum())


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_streaming_step_matches_jax(nets, d):
    tspec, jspec, xs = nets["tspec"], nets["jspec"], nets["xs"]
    r, hop = tspec.residual, tspec.hop
    tcarry = tnn.stack_params(
        [tdet.streaming_init(tspec, torch.from_numpy(x[:r])) for x in xs]
    )
    jcarry = jax.tree.map(jnp.asarray, jax.tree.map(lambda t: t.numpy(), tcarry))
    tstack, jstack = tnn.stack_params(nets["tparams"]), jnn.stack_params(nets["jparams"])
    pos, rows = r, []
    for hops in (6, 6, 9):
        chunk = xs[:, pos : pos + hops * hop]
        pos += hops * hop
        tcarry, tout = tmesh.sharded_streaming_step(
            cpu_mesh(d), tspec, tstack, tcarry, torch.from_numpy(np.ascontiguousarray(chunk))
        )
        jcarry, jout = jmesh.sharded_streaming_step(
            jmesh.make_mesh(d), jspec, jstack, jcarry, jnp.asarray(chunk)
        )
        assert tout.shape == (LANES, hops, 1)
        close(tout.numpy(), jout)
        for key in ("residual", "history"):
            close(tcarry[key].numpy(), jcarry[key])
        rows.append(tout)
    # past the warm-up, the steps give each lane's streaming_scan outputs
    got = torch.cat(rows, dim=1)[:, tspec.history :]
    for lane in range(LANES):
        scan = tdet.streaming_scan(tspec, nets["tparams"][lane], torch.from_numpy(xs[lane, :pos]))
        close(got[lane].numpy(), scan[: got.shape[1]].numpy(), 1e-6, 1e-6)


@pytest.mark.parametrize("method", ["matmul", "fused"])
@pytest.mark.parametrize("d", SHARDS)
def test_time_sharded_matches_jax(nets, d, method):
    x = fixtures.chirp_audio(1.0, 33)
    tspec, tparams = nets["tspec"], nets["tparams"][0]
    got = tmesh.time_sharded_offline_outputs(
        tmesh.make_mesh(d, axis="time", devices=[CPU]), tspec, tparams,
        torch.from_numpy(x), method=method,
    )
    want = jmesh.time_sharded_offline_outputs(
        jmesh.make_mesh(d, axis="time"), nets["jspec"], nets["jparams"][0],
        jnp.asarray(x), method=method,
    )
    tol = (1e-3, 2e-4) if method == "fused" else (1e-4, 1e-5)
    close(got.numpy(), want, *tol)
    whole = tdet.offline_outputs(tspec, tparams, torch.from_numpy(x))
    close(got.numpy(), whole.numpy(), *tol)
    assert np.isnan(got.numpy()).any()  # the chirp's digital silence crosses shards


def test_time_sharded_short_stream_falls_back(nets):
    """Segments shorter than the halo cannot feed their neighbour: the
    stream goes through the unsharded path, as in the JAX function."""
    tspec, tparams = nets["tspec"], nets["tparams"][0]
    x = fixtures.chirp_audio(0.2, 34)  # 56 evaluations: 7 per shard, under the halo
    mesh = tmesh.make_mesh(8, axis="time", devices=[CPU])
    got = tmesh.time_sharded_offline_outputs(mesh, tspec, tparams, torch.from_numpy(x))
    whole = tdet.offline_outputs(tspec, tparams, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    want = jmesh.time_sharded_offline_outputs(
        jmesh.make_mesh(8, axis="time"), nets["jspec"], nets["jparams"][0], jnp.asarray(x)
    )
    close(got.numpy(), want)
    none = tmesh.time_sharded_offline_outputs(mesh, tspec, tparams, torch.zeros(1000))
    assert none.shape == (0, 1)


@pytest.mark.parametrize("scaling", ["linear", "log", "db"])
@pytest.mark.parametrize("d", SHARDS)
def test_tensor_sharded_matches_jax(d, scaling):
    cfg = fixtures.sample_geometry_config(
        66, hidden=(6, 3), transfers=("TanSig", "LogSig", "PureLin"), scaling=scaling
    )
    tspec, tparams, jspec, jparams = both(cfg)
    x = fixtures.chirp_audio(0.3, 35)
    mesh = cpu_mesh(d)
    got = tmesh.tensor_sharded_offline_outputs(mesh, tspec, tparams, torch.from_numpy(x))
    want = jmesh.tensor_sharded_offline_outputs(jmesh.make_mesh(d), jspec, jparams, jnp.asarray(x))
    close(got.numpy(), want, 1e-3, 2e-4)
    whole = tdet.offline_outputs(tspec, tparams, torch.from_numpy(x))
    close(got.numpy(), whole.numpy(), 1e-3, 2e-4)
    # the constant fold is kept per (spec, params, mesh size)
    key = (tspec, id(tparams), d)
    assert tmesh._tp_const_cache[key][1] is tparams
    again = tmesh.tensor_sharded_offline_outputs(mesh, tspec, tparams, torch.from_numpy(x))
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    assert tmesh.tensor_sharded_offline_outputs(mesh, tspec, tparams, torch.zeros(500)).shape == (0, 1)


def test_channels_must_divide_by_the_mesh(nets):
    xs = torch.from_numpy(nets["xs"][:6])
    stack = tnn.stack_params(nets["tparams"][:6])
    mesh = cpu_mesh(4)
    msg = "channels 6 must divide by mesh size 4"
    with pytest.raises(ValueError, match=msg):
        tmesh.sharded_fused_offline_outputs(mesh, nets["tspec"], nets["tparams"][0], xs)
    with pytest.raises(ValueError, match=msg):
        jmesh.sharded_fused_offline_outputs(
            jmesh.make_mesh(4), nets["jspec"], nets["jparams"][0], jnp.asarray(nets["xs"][:6])
        )
    with pytest.raises(ValueError, match=msg):
        tmesh.sharded_offline_outputs(mesh, nets["tspec"], stack, xs)
    with pytest.raises(ValueError, match=msg):
        tmesh.sharded_detection_counts(mesh, nets["tspec"], stack, xs)


@pytest.mark.parametrize("method", ["matmul", "fused"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
def test_scan_corpus_pads_lanes_to_the_mesh(nets, method, per_lane):
    """3 streams on a 2-shard mesh: the lanes are padded to 4 (the padding
    lane on net 0) and the padding is sliced away."""
    cfgs = nets["cfgs"]
    streams = [nets["xs"][0], nets["xs"][1][:6000], nets["xs"][2][:3000]]
    lane_cfgs = cfgs[:3] if per_lane else None
    got = tcorpus.scan_corpus(
        cfgs[0], streams, method=method, mesh=cpu_mesh(2), lane_configs=lane_cfgs, device="cpu"
    )
    plain = tcorpus.scan_corpus(cfgs[0], streams, method=method, lane_configs=lane_cfgs, device="cpu")
    want = jcorpus.scan_corpus(
        cfgs[0], streams, method="matmul", mesh=jmesh.make_mesh(2), lane_configs=lane_cfgs
    )
    assert len(got) == len(plain) == len(want) == 3
    tol = (1e-3, 2e-4) if method == "fused" else (1e-4, 1e-5)
    for g, p, w in zip(got, plain, want):
        close(g, p, 1e-6, 1e-6)
        close(g, w, *tol)


def test_cli_mesh_matches_unsharded(nets, tmp_path):
    from syllable_detector_tpu.config.model_format import save_config
    from syllable_detector_tpu.utils.wav import write_wav

    net, wav = str(tmp_path / "net.txt"), str(tmp_path / "three.wav")
    save_config(nets["cfgs"][0], net)
    write_wav(wav, nets["xs"][:3].T, 44100, dtype="float32")
    argv = ["-n", net, "-a", wav, "--batched", "--method", "fused", "--device", "cpu"]
    rc, got, err = run(port_main, argv + ["--mesh"])
    rc2, want, _ = run(port_main, argv)
    assert rc == rc2 == 0 and got == want and len(got) > 3
    assert "Mesh: 1 shard(s) on cpu." in err
