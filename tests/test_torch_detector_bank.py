"""The port's batched live path against the JAX package: the stacked fold,
the wire dequantisers, the batched kernel's plain version, and the
DetectorBank over a seeded lifecycle.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode. Tolerances are the fused kernel's against its unfused path,
rtol=1e-3, atol=2e-4, with NaN in the same places; sample indices, counts
and state must be equal. The nets come from the port's seeded fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.config.model_format import ProcessingSpec
from syllable_detector_tpu.kernels import fused_detector as jfused
from syllable_detector_tpu.models import detector as jdet
from syllable_detector_tpu.models.detector_bank import DetectorBank as JaxBank
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.kernels import fused_detector as tfused
from syllable_detector_tpu_torch.models import detector as tdet
from syllable_detector_tpu_torch.models import detector_bank as tbank
from syllable_detector_tpu_torch.models.detector_bank import DetectorBank
from syllable_detector_tpu_torch.models.neural_net import params_from_numpy

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 2e-4
WIRES = ["float32", "int16", "mulaw8"]
SEEDS = (11, 12, 13)


@pytest.fixture(scope="module")
def audio():
    return [fixtures.chirp_audio(1.5, seed) for seed in SEEDS]


@pytest.fixture(scope="module")
def cfgs(audio):
    """Three distinct nets of one geometry, each threshold away from every
    output on its lane's audio, so no decision can flip."""
    return [
        fixtures.pick_thresholds(fixtures.sample_geometry_config(seed), a)
        for seed, a in zip(SEEDS, audio)
    ]


def both(cfgs):
    """(port spec, port params list, JAX spec, JAX params list) from the
    same weights."""
    jpairs = [jdet.detector_spec_from_config(c) for c in cfgs]
    tspec = tdet.detector_spec_from_config(cfgs[0], "cpu")[0]
    tparams = [params_from_numpy(jax.tree.map(np.asarray, p), "cpu") for _, p in jpairs]
    return tspec, tparams, jpairs[0][0], [p for _, p in jpairs]


def wire_samples(rng, lanes, n, wire):
    """Seeded wire samples: mostly audio-like, with a run of zeros in lane 0
    (digital silence, NaN under l2normalize)."""
    x = rng.uniform(-0.6, 0.6, (lanes, n)).astype(np.float32)
    x[0, 1000:3000] = 0.0
    if wire == "float32":
        return x
    q = np.rint(x * 32767.0).astype(np.int16)
    return q if wire == "int16" else tbank._mulaw_lut()[q.astype(np.int32) + 32768]


def test_fold_constants_stacked_matches_jax(cfgs):
    tspec, tparams, jspec, jparams = both(cfgs)
    got = tfused.fold_constants_stacked(tspec, tparams, "cpu")
    ops, meta = jfused.fold_constants_stacked(jspec, jparams)
    b, hs = meta.b, meta.hs
    eq = np.testing.assert_array_equal
    assert got.per_lane and got.w1.shape[0] == len(cfgs)
    eq(got.c[:, :b].numpy(), ops[0][:, :b])
    im0 = meta.b_pad // 2 if meta.packed else meta.b_pad
    eq(got.c[:, b:].numpy(), ops[0][:, im0 : im0 + b])
    h1 = got.c1.shape[1]
    for lane in range(len(cfgs)):
        for t in range(tspec.time_range):
            eq(got.w1[lane, t].numpy(), ops[1][lane, :b, t * hs : t * hs + h1])
        eq(got.c1[lane].numpy(), ops[2][lane, 0, :h1])
        n_out = tspec.net.outputs
        eq(got.out_a[lane].numpy(), ops[-2][lane, 0, :n_out])
        eq(got.out_c[lane].numpy(), ops[-1][lane, 0, :n_out])
        # each lane's fold is the single-net fold of its own net
        one = tfused.fold_constants(tspec, tparams[lane], "cpu")
        eq(got.w1[lane].numpy(), one.w1.numpy())
        eq(got.mids_flat[lane].numpy(), one.mids_flat.numpy())
    with pytest.raises(ValueError, match="at least one"):
        tfused.fold_constants_stacked(tspec, [], "cpu")


def test_stack_params_matches_jax(cfgs):
    from syllable_detector_tpu.models.neural_net import stack_params as jstack
    from syllable_detector_tpu_torch.models.neural_net import stack_params

    _, tparams, _, jparams = both(cfgs)
    got, want = stack_params(tparams), jax.tree.map(np.asarray, jstack(jparams))
    flat_got = jax.tree_util.tree_leaves(jax.tree.map(lambda t: t.numpy(), got))
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want) > 4
    for g, w in zip(flat_got, flat_want):
        assert g.shape[0] == len(cfgs)
        np.testing.assert_array_equal(g, w)


def test_int16_dequant_is_bit_exact_with_jax():
    codes = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    got = tfused.dequant_int16(torch.from_numpy(codes)).numpy()
    want = np.asarray(
        jax.jit(lambda v: v.astype(jnp.float32) * np.float32(1.0 / 32767.0))(codes)
    )
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_mulaw8_dequant_within_two_ulp_of_jax():
    codes = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    got = tfused.dequant_mulaw8(torch.from_numpy(codes)).numpy()
    ln1mu, inv_mu, inv127 = (np.float32(np.log1p(255.0)), np.float32(1 / 255.0),
                             np.float32(1 / 127.0))

    def expand(v):
        y = v.astype(jnp.float32) * inv127
        return jnp.sign(y) * (jnp.expm1(jnp.abs(y) * ln1mu) * inv_mu)

    want = np.asarray(jax.jit(expand)(codes))
    # expm1 is a libm call on both sides: 74 of the 256 codes differ, by at
    # most 2 ulp
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2, ulp.max()
    np.testing.assert_allclose(got, tbank.mulaw_expand_np(codes), rtol=1e-6, atol=0)
    assert got[codes == 0] == 0.0 and np.all(np.sign(got) == np.sign(codes))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("nets", ["shared", "distinct"])
def test_batch_plain_version_matches_jax(cfgs, wire, nets):
    tspec, tparams, jspec, jparams = both(cfgs)
    lanes = len(cfgs)
    if nets == "shared":
        tparams, jparams = [tparams[0]] * lanes, [jparams[0]] * lanes
    rng = np.random.default_rng(7)
    n = 5536  # 32 evaluations: (32 + T - 2) * hop + window
    xs = wire_samples(rng, lanes, n, wire)
    folded = (
        tfused.fold_constants_stacked(tspec, tparams, "cpu")
        if nets == "distinct"
        else tfused.fold_constants(tspec, tparams[0], "cpu")
    )
    got = tfused.fused_batch_outputs_reference(tspec, folded, torch.from_numpy(xs), wire).numpy()
    prog = jfused.fused_batch_program(jspec, jparams, n, wire, interpret=True)
    want_prog = np.asarray(prog(jnp.asarray(xs)))
    x32 = tfused.dequant(torch.from_numpy(xs), wire)
    want_flat = np.asarray(
        jfused.fused_flat_batch_offline_outputs(
            jspec, jparams if nets == "distinct" else jparams[0],
            jnp.asarray(x32.numpy()), interpret=True,
        )
    )
    assert got.shape == want_prog.shape == want_flat.shape == (lanes, 32, 1)
    for want in (want_prog, want_flat):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isnan(got[0]).any() and not np.isnan(got[1:]).any()

    # the port's entries run that plain version on CPU tensors and never launch
    launches = (tfused.BATCH_LAUNCHES, dict(tfused.PROGRAM_LAUNCHES))
    port_prog = tfused.fused_batch_program(tspec, tparams, n, wire, device="cpu")
    np.testing.assert_allclose(port_prog(torch.from_numpy(xs)), got, rtol=1e-6, atol=1e-7)
    flat = tfused.fused_flat_batch_offline_outputs(
        tspec, tparams if nets == "distinct" else tparams[0], x32
    ).numpy()
    np.testing.assert_allclose(flat, got, rtol=1e-6, atol=1e-7)
    assert (tfused.BATCH_LAUNCHES, tfused.PROGRAM_LAUNCHES) == launches


def test_flat_batch_n_evals_contract_and_tiers(cfgs):
    tspec, tparams, jspec, jparams = both(cfgs)
    xs = torch.from_numpy(wire_samples(np.random.default_rng(3), 3, 5536, "float32"))
    with pytest.raises(ValueError, match="needs more than"):
        tfused.fused_flat_batch_offline_outputs(tspec, tparams, xs, n_evals=33)
    with pytest.raises(ValueError, match="needs more than"):
        jfused.fused_flat_batch_offline_outputs(
            jspec, jparams, jnp.asarray(xs.numpy()), n_evals=33, interpret=True
        )
    short = tfused.fused_flat_batch_offline_outputs(tspec, tparams, xs, n_evals=5)
    full = tfused.fused_batch_offline_outputs(tspec, tparams, xs)
    np.testing.assert_array_equal(short.numpy(), full[:, :5].numpy())
    with pytest.raises(ValueError, match="per-channel networks"):
        tfused.fused_flat_batch_offline_outputs(tspec, tparams[:2], xs)
    # the tiers and the grid layout run (tests/test_torch_tiers.py holds them
    # against the JAX kernel); packed and the fp32 grid change no value
    for kw, atol in (({"fast": True}, 1e-2), ({"split": True}, 5e-4),
                     ({"packed": True}, 0.0), ({"layout": "grid", "slab_channels": 2}, 0.0)):
        got = tfused.fused_batch_offline_outputs(tspec, tparams, xs, **kw)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=atol)
    with pytest.raises(ValueError, match="unknown split"):
        tfused.fused_batch_offline_outputs(tspec, tparams, xs, split=3)
    with pytest.raises(ValueError, match="unknown layout"):
        tfused.fused_batch_offline_outputs(tspec, tparams, xs, layout="rows")
    assert tfused.fused_batch_program(tspec, tparams, 1000, "int16", "cpu") is None
    with pytest.raises(ValueError, match="per-lane params list"):
        tfused.fused_batch_program(tspec, tparams[0], 5536, "int16", "cpu")
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        tfused.fused_batch_program(tspec, tparams, 5536, "int8", "cpu")


def run_lifecycle(bank, audio, seed):
    """A seeded script of bank operations; returns one record per drain.
    The operations depend on ``seed`` only, so two banks given the same
    seed see the same calls."""
    rng = np.random.default_rng(seed)
    lanes = bank.n_lanes
    pos = [0] * lanes
    records = []

    def drain(flush=False):
        out = bank.drain(flush=flush)
        records.append(
            (out, bank.last_counts.copy(), [a.copy() for a in bank.last_sample_indices])
        )

    def take(lane, n):
        chunk = audio[lane][pos[lane] : pos[lane] + n]
        pos[lane] += len(chunk)
        return chunk

    for step in range(16):
        for lane in range(lanes):
            r = rng.random()
            if r < 0.6:
                bank.append_audio_data(lane, take(lane, int(rng.integers(50, 4000))))
            elif r < 0.7:
                bank.note_gap(lane, int(rng.integers(1, 3000)))
        if step == 5:
            # a chunk over the buffer cap is dropped and counted as a gap
            assert not bank.append_audio_data(1, np.zeros(bank.max_buffer_samples + 1, np.float32))
        if step == 8:
            # interleaved capture with a trailing partial frame, then a gap
            # on the interleaved stream that discards the carried sample
            frames = np.stack([take(lane, 700) for lane in range(lanes)], axis=1)
            flat = frames.reshape(-1)
            bank.append_interleaved_audio_data(flat[:1001])
            bank.append_interleaved_audio_data(flat[1001:2000])
            bank.note_interleaved_gap(3 * lanes + 1)
        if step == 12:
            records.append((bank.seen_syllables(), bank.last_counts.copy(), None))
        elif rng.random() < 0.5:
            drain()
    drain()  # min_drain_hops may leave a tail
    drain(flush=True)
    return records


def compare_records(got, want):
    assert len(got) == len(want)
    for (g, gc, gi), (w, wc, wi) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
            continue
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        for a, b in zip(gi, wi):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("method", ["fused", "matmul"])
def test_lifecycle_matches_jax_bank(cfgs, audio, method, wire):
    kw = dict(method=method, transfer_dtype=wire, buckets=(8, 32),
              max_buffer_seconds=0.5, min_drain_hops=4)
    port = DetectorBank(cfgs, device="cpu", **kw)
    ref = JaxBank(cfgs, **kw)
    got = run_lifecycle(port, audio, seed=5)
    want = run_lifecycle(ref, audio, seed=5)
    compare_records(got, want)
    assert sum(int(c.sum()) for _, c, i in got if i is not None) > 100
    assert port.overflows == ref.overflows and port.dropped_samples == ref.dropped_samples
    assert port.hops_emitted == ref.hops_emitted
    assert port.overflows[1] >= 2  # the cap drop and the interleaved gap
    gs, ws = port.get_state(), ref.get_state()
    for k in ("offered", "hops_emitted", "overflows", "dropped_samples"):
        assert gs[k] == ws[k], k
    for gsegs, wsegs in zip(gs["segments"], ws["segments"]):
        assert [(s, c) for s, _, c in gsegs] == [(s, c) for s, _, c in wsegs]
        for (_, gd, _), (_, wd, _) in zip(gsegs, wsegs):
            np.testing.assert_array_equal(gd, wd)


def test_default_ladder_backlog_matches_jax(cfgs, audio):
    """A backlog past the largest pinned bucket drains in several rounds;
    the default ladder takes it in one, with the same outputs."""
    outs = []
    for bank in (
        DetectorBank(cfgs, device="cpu", transfer_dtype="int16"),
        DetectorBank(cfgs, device="cpu", transfer_dtype="int16", buckets=(8, 32)),
        JaxBank(cfgs, transfer_dtype="int16"),
    ):
        for lane in range(3):
            bank.append_audio_data(lane, audio[lane][: 20000 + 3000 * lane])
        outs.append((bank.drain(), bank.last_counts.copy()))
    for out, counts in outs[1:]:
        np.testing.assert_array_equal(counts, outs[0][1])
        np.testing.assert_allclose(out, outs[0][0], rtol=RTOL, atol=ATOL)
    assert outs[0][0].shape[1] > 128


@pytest.mark.parametrize("method", ["fused", "matmul"])
def test_jax_state_continues_in_port(cfgs, audio, method, tmp_path):
    kw = dict(method=method, transfer_dtype="int16", buckets=(8, 32))
    ref = JaxBank(cfgs, **kw)
    for lane in range(3):
        ref.append_audio_data(lane, audio[lane][:9000 + 500 * lane])
    ref.drain()
    ref.note_gap(2, 777)
    ref.append_audio_data(2, audio[2][12000:14000])
    ref.append_interleaved_audio_data(np.zeros(7, np.float32))  # carries 1 sample
    port = DetectorBank(cfgs, device="cpu", **kw)
    port.set_state(ref.get_state())
    # and through the port's own files
    port.save_state(tmp_path / "bank.npz")
    restored = DetectorBank(cfgs, device="cpu", **kw)
    restored.load_state(tmp_path / "bank.npz")
    for bank in (ref, port, restored):
        for lane in range(3):
            bank.append_audio_data(lane, audio[lane][20000:26000])
    want = ref.drain()
    for bank in (port, restored):
        np.testing.assert_allclose(bank.drain(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(bank.last_counts, ref.last_counts)
        for a, b in zip(bank.last_sample_indices, ref.last_sample_indices):
            np.testing.assert_array_equal(a, b)
        assert bank.hops_emitted == ref.hops_emitted
        assert bank.overflows == ref.overflows


def test_legacy_state_schema_matches_jax(cfgs, audio):
    state = {
        "residuals": [audio[0][:5000], np.zeros(0, np.float32), audio[2][:3000]],
        "frames_seen": 7,
        "last_outputs": np.zeros((3, 1), np.float32),
        "overflows": [0, 1, 0],
    }
    port, ref = DetectorBank(cfgs, device="cpu"), JaxBank(cfgs)
    port.set_state(state)
    ref.set_state(state)
    for bank in (port, ref):
        bank.append_audio_data(1, audio[1][:4000])
    np.testing.assert_allclose(port.drain(), ref.drain(), rtol=RTOL, atol=ATOL)
    for a, b in zip(port.last_sample_indices, ref.last_sample_indices):
        np.testing.assert_array_equal(a, b)
    assert port.get_state()["offered"] == ref.get_state()["offered"]


@pytest.mark.parametrize("wire", WIRES)
def test_nan_chunks_on_the_wire(cfgs, audio, wire):
    """Non-finite samples become 0 before the int16 and mu-law wires (the
    JAX package's native stager crashes on them there); the float32 wire
    passes them through. Padding rows never reach the result."""
    bad = audio[0][:6000].copy()
    bad[100:400] = np.nan
    bad[500] = np.inf
    bad[501] = -np.inf
    zeroed = np.nan_to_num(bad, nan=0.0, posinf=0.0, neginf=0.0)
    outs = []
    for chunk in (bad, zeroed):
        bank = DetectorBank(cfgs, device="cpu", transfer_dtype=wire, buckets=(8, 32))
        bank.append_audio_data(0, chunk)
        bank.append_audio_data(1, audio[1][:2000])  # a shorter lane: padded rows
        outs.append((bank.drain(), bank.last_counts.copy()))
    (got, counts), (want, want_counts) = outs
    np.testing.assert_array_equal(counts, want_counts)
    assert counts[1] < counts[0] and counts[2] == 0
    # padding is zero, never the NaN the kernel gives on zero audio
    assert not np.isnan(got[1, counts[1] :]).any() and not got[2].any()
    if wire == "float32":
        assert np.isnan(got[0, :4]).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wire", WIRES)
def test_native_and_numpy_staging_agree(cfgs, audio, wire):
    """The native stager (behind its non-finite guard) and the numpy
    staging fill the wire buffer with the same bytes, stale tails
    included, and the drains agree exactly."""
    native = DetectorBank(cfgs, device="cpu", transfer_dtype=wire, buckets=(8, 32))
    plain = DetectorBank(cfgs, device="cpu", transfer_dtype=wire, buckets=(8, 32))
    assert native._stager is not None
    plain._stager = None
    bad = audio[0][:9000].copy()
    bad[2000:2100] = np.nan
    bad[4000] = np.inf
    for step, lengths in enumerate([(9000, 2500, 0), (300, 6000, 1400)]):
        for bank in (native, plain):
            for lane, n in enumerate(lengths):
                chunk = bad if (lane, step) == (0, 0) else audio[lane][10000 : 10000 + n]
                bank.append_audio_data(lane, chunk[:n])
        need = 5536
        avail = [native._front_avail(lane) for lane in range(3)]
        got = native._stage_round(avail, need).numpy().copy()
        want = plain._stage_round(avail, need).numpy().copy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(native._stage[need][2], plain._stage[need][2])
        np.testing.assert_array_equal(native.drain(), plain.drain())


def test_seen_syllables_ignore_padding(cfgs, audio):
    """Silent lanes give NaN rows, shorter lanes padded rows; neither can
    count as a detection."""
    bank = DetectorBank(cfgs, device="cpu")
    ref = JaxBank(cfgs)
    for b in (bank, ref):
        b.append_audio_data(0, audio[0][:20000])
        b.append_audio_data(1, np.zeros(20000, np.float32))
    got, want = bank.seen_syllables(), ref.seen_syllables()
    np.testing.assert_array_equal(got, want)
    assert not got[1] and not got[2]


def test_rejects_bad_arguments(cfgs):
    other = fixtures.sample_geometry_config(1, hidden=(5,))
    with pytest.raises(ValueError, match="geometry"):
        DetectorBank([cfgs[0], other], device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        DetectorBank(cfgs, method="fussed", device="cpu")
    with pytest.raises(ValueError, match="transfer_dtype"):
        DetectorBank(cfgs, transfer_dtype="int8", device="cpu")
    for buckets in ((), (32, 8), (0, 8), (8, 8)):
        with pytest.raises(ValueError, match="buckets"):
            DetectorBank(cfgs, buckets=buckets, device="cpu")
    with pytest.raises(ValueError, match="at least one lane"):
        DetectorBank([], device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        DetectorBank(cfgs, device="cpu").set_state(DetectorBank(cfgs[:2], device="cpu").get_state())
    bad = dataclasses.replace(cfgs[0], process_inputs=[ProcessingSpec("normalize")])
    assert DetectorBank([bad], device="cpu").method == "matmul"


def test_warm_up_builds_every_shape(cfgs):
    bank = DetectorBank(cfgs, device="cpu", transfer_dtype="mulaw8", buckets=(8, 32))
    assert bank.warm_up() == 2
    assert sorted(bank._programs) == [2368, 5536]
    assert bank.warm_up(buckets=(128,)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_batched_kernel_matches_plain_version_on_card(cfgs, wire):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = [tdet.detector_spec_from_config(c, "cuda") for c in cfgs]
    spec, params = pairs[0][0], [p for _, p in pairs]
    n = 6251  # 37 evaluations: not a whole tile
    xs = wire_samples(np.random.default_rng(8), 3, n, wire)
    xs[1, 3000:] = 0  # a zero tail, as the bank pads: NaN rows
    xd = torch.from_numpy(xs).cuda()
    for folded in (
        tfused.fold_constants_stacked(spec, params, "cuda"),
        tfused.fold_constants(spec, params[0], "cuda"),
    ):
        prog = tfused.BatchProgram(spec, folded, 3, n, 37, wire, "cuda")
        before = (tfused.BATCH_LAUNCHES, dict(tfused.PROGRAM_LAUNCHES))
        got = prog.launch(xd).cpu().numpy()
        assert (tfused.BATCH_LAUNCHES, tfused.PROGRAM_LAUNCHES) != before
        want = tfused.fused_batch_outputs_reference(spec, folded, xd, wire, 37).cpu().numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert np.isnan(got[1]).any()
