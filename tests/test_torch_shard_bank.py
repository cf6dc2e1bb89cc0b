"""The port's lane-sharded multi-process bank (``runtime/shard_bank.py``):
workers stage in their own processes into shared memory, and this process
evaluates every round on the CPU here. On the fused route results must
equal the port's single-process ``DetectorBank`` bit for bit (the staging,
ladder and drain program are the same code); on the unfused route they
must equal it and the JAX ``DetectorBank`` within rtol=1e-4, atol=1e-5.
Counts and sample indices are always equal. A
worker that fails a drain makes ``drain`` raise after every reply of the
round is read, so the next round stays aligned."""

import dataclasses

import numpy as np
import pytest
import torch

from syllable_detector_tpu.config.model_format import loads_config as jloads
from syllable_detector_tpu.models.detector_bank import DetectorBank as JaxBank
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.config.model_format import ProcessingSpec, dumps_config
from syllable_detector_tpu_torch.models.detector_bank import DetectorBank
from syllable_detector_tpu_torch.runtime.shard_bank import ShardedDetectorBank

torch.set_num_threads(1)

N = 5
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def cfgs():
    return [fixtures.sample_geometry_config(60 + i) for i in range(N)]


@pytest.fixture(scope="module")
def streams():
    return [fixtures.chirp_audio(0.35 + 0.05 * i, 60 + i) * 1.1 for i in range(N)]


def sharded(cfgs, **kw):
    return ShardedDetectorBank(cfgs, device="cpu", **kw)


def assert_same_round(bank, got, oracle, want, exact=True):
    np.testing.assert_array_equal(bank.last_counts, oracle.last_counts)
    for i in range(bank.n_lanes):
        np.testing.assert_array_equal(bank.last_sample_indices[i], oracle.last_sample_indices[i])
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(bank.last_outputs, oracle.last_outputs)
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["fused", "matmul"])
@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_sharded_bank_matches_single_process(cfgs, streams, wire, method):
    """5 lanes over 2 workers (3 + 2), distinct nets, uneven fills, a gap
    mid-stream, rounds over two buckets and a final flush; on the unfused
    route also the JAX bank, fed the same stream."""
    kw = dict(transfer_dtype=wire, buckets=(8, 32), method=method)
    oracle = DetectorBank(cfgs, device="cpu", **kw)
    jax = (JaxBank([jloads(dumps_config(c)) for c in cfgs], **kw)
           if method == "matmul" else None)
    with sharded(cfgs, n_workers=2, **kw) as bank:
        assert bank.warm_up() == 4  # 2 buckets x 2 shards, before serving
        for r in range(4):
            for i, s in enumerate(streams):
                chunk = s[r * len(s) // 4 : (r + 1) * len(s) // 4]
                for b in filter(None, (bank, oracle, jax)):
                    if r == 2 and i in (1, 4):
                        b.note_gap(i, 777)
                    b.append_audio_data(i, chunk)
            got = bank.drain(flush=r == 3)
            # the unfused route vmaps over each shard's lanes, and a batch of
            # another size may round differently in the last bit
            assert_same_round(bank, got, oracle, oracle.drain(flush=r == 3),
                              exact=method == "fused")
            if jax is not None:
                assert_same_round(bank, got, jax, jax.drain(flush=r == 3), exact=False)
        assert bank.hops_emitted == oracle.hops_emitted
        with pytest.raises(RuntimeError, match="before the server"):
            bank.warm_up()


def test_sharded_bank_overflow_accounting(cfgs):
    """Buffer-cap drops happen in the workers' banks; the parent aggregates
    the per-lane totals, and post-drop outputs match an oracle of the same
    cap."""
    big = fixtures.chirp_audio(1.2, 3)
    kw = dict(max_buffer_seconds=0.5, buckets=(8,), min_drain_hops=1)
    oracle = DetectorBank(cfgs[:2], device="cpu", **kw)
    with sharded(cfgs[:2], n_workers=2, **kw) as bank:
        for i in range(2):
            bank.append_audio_data(i, big)
            oracle.append_audio_data(i, big)
        assert_same_round(bank, bank.drain(flush=True), oracle, oracle.drain(flush=True))
        assert bank.overflows == oracle.overflows and sum(bank.overflows) > 0
        assert bank.dropped_samples == oracle.dropped_samples


def test_sharded_bank_unfusable_routes_matmul(cfgs):
    """An unfusable input chain takes the unfused route on both sides."""
    cfg = dataclasses.replace(cfgs[0], process_inputs=[ProcessingSpec("normalize")])
    audio = fixtures.chirp_audio(0.4, 5)
    oracle = DetectorBank([cfg, cfg], buckets=(16,), device="cpu")
    assert oracle.method == "matmul"
    with sharded([cfg, cfg], n_workers=2, buckets=(16,)) as bank:
        assert all(b.method == "matmul" for b in bank._server.banks)
        for i in range(2):
            bank.append_audio_data(i, audio)
            oracle.append_audio_data(i, audio)
        assert_same_round(bank, bank.drain(flush=True), oracle, oracle.drain(flush=True))


def test_sharded_bank_seen_and_lifecycle(cfgs):
    """seen_syllables drains through the wire; close() is idempotent and
    stops every worker; a drain after close raises."""
    audio = fixtures.chirp_audio(0.5, 9) * 1.5
    oracle = DetectorBank(cfgs[:3], buckets=(32,), device="cpu")
    bank = sharded(cfgs[:3], n_workers=3, buckets=(32,))
    try:
        for i in range(3):
            bank.append_audio_data(i, audio)
            oracle.append_audio_data(i, audio)
        np.testing.assert_array_equal(bank.seen_syllables(), oracle.seen_syllables())
    finally:
        bank.close()
    bank.close()
    assert not any(p.is_alive() for p in bank._workers)
    with pytest.raises(RuntimeError, match="closed"):
        bank.drain()


def test_sharded_bank_validates_args(cfgs):
    with pytest.raises(ValueError, match="n_workers"):
        sharded(cfgs[:1], n_workers=2)
    with pytest.raises(ValueError, match="transfer_dtype"):
        sharded(cfgs[:1], n_workers=1, transfer_dtype="f8")
    with pytest.raises(IndexError):
        with sharded(cfgs[:2], n_workers=1) as bank:
            bank.append_audio_data(2, np.zeros(10, np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedDetectorBank(cfgs[:2], n_workers=1)


def test_failed_worker_round_keeps_next_round_aligned(cfgs, streams):
    """Worker 0 fails one drain: drain raises once the whole round's replies
    are in, and the next round is worker 1's own (not its queued reply from
    the failed round). Worker 0 drained nothing in the failed round, so its
    lanes deliver both rounds' outputs next; worker 1's lanes deliver the
    next round's only."""
    oracle = DetectorBank(cfgs, buckets=(8, 32), device="cpu")
    with sharded(cfgs, n_workers=2, buckets=(8, 32)) as bank:
        thirds = [[s[k * len(s) // 3 : (k + 1) * len(s) // 3] for k in range(3)] for s in streams]

        def feed(k):
            for i in range(N):
                bank.append_audio_data(i, thirds[i][k])
                oracle.append_audio_data(i, thirds[i][k])

        feed(0)
        assert_same_round(bank, bank.drain(), oracle, oracle.drain())
        # an append to a lane worker 0 does not have fails in the worker,
        # and its next drain reports that failure without draining
        bank._cmd_qs[0].put(("append", 99, np.zeros(4, np.float32)))
        feed(1)
        with pytest.raises(RuntimeError, match="worker 0 drain failed"):
            bank.drain()
        skipped = oracle.drain()
        skipped_counts = oracle.last_counts.copy()
        skipped_idx = [a.copy() for a in oracle.last_sample_indices]
        feed(2)
        got = bank.drain()
        want = oracle.drain()
        lo = 3  # worker 0 holds lanes 0-2
        for i in range(lo, N):
            c = int(oracle.last_counts[i])
            assert int(bank.last_counts[i]) == c
            np.testing.assert_array_equal(got[i, :c], want[i, :c])
            np.testing.assert_array_equal(bank.last_sample_indices[i], oracle.last_sample_indices[i])
        for i in range(lo):
            both = np.concatenate([skipped[i, : skipped_counts[i]],
                                   want[i, : oracle.last_counts[i]]])
            assert int(bank.last_counts[i]) == len(both)
            np.testing.assert_array_equal(
                bank.last_sample_indices[i],
                np.concatenate([skipped_idx[i], oracle.last_sample_indices[i]]))
            np.testing.assert_allclose(got[i, : len(both)], both, rtol=1e-6, atol=1e-6)


def test_stopped_server_fails_the_drain(cfgs, monkeypatch):
    """A device server thread that stopped answers no round: the drain
    raises instead of waiting for ever."""
    from syllable_detector_tpu_torch.runtime.shard_bank import WireDeviceServer

    monkeypatch.setattr(WireDeviceServer, "_serve", lambda self: None)
    with sharded(cfgs[:2], n_workers=1, buckets=(8,)) as bank:
        bank.append_audio_data(0, fixtures.chirp_audio(0.2, 1))
        with pytest.raises(RuntimeError, match="device server thread stopped"):
            bank.drain()
