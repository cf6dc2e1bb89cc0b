"""The port's crash-isolated detector (``runtime/resilient.py``): the JAX
tests' behaviours on fixture nets, with the child's bank on the CPU. After a
crash (and across gaps, interleaved capture and warm-up) the outputs equal
an uninterrupted JAX ``DetectorBank`` fed the same chunks: counts and sample
indices equal, outputs within rtol=1e-4, atol=1e-5 (the unfused path's
bound against the JAX package, both sides on the unfused route); the fused
route equals an in-process port bank. Every child is reaped by ``close``;
the tests check that none outlives its detector."""

import numpy as np
import pytest
import torch

from syllable_detector_tpu.config.model_format import loads_config as jloads
from syllable_detector_tpu.models.detector_bank import DetectorBank as JaxBank
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.config.model_format import dumps_config
from syllable_detector_tpu_torch.models.detector_bank import DetectorBank
from syllable_detector_tpu_torch.runtime import resilient as rmod
from syllable_detector_tpu_torch.runtime.resilient import (
    DetectorChildError,
    ResilientDetector,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def cfgs():
    return [fixtures.sample_geometry_config(seed) for seed in (41, 42)]


def jax_bank(cfgs, **kw):
    return JaxBank([jloads(dumps_config(c)) for c in cfgs], method="matmul", **kw)


def resilient(cfgs, **kw):
    kw.setdefault("method", "matmul")
    return ResilientDetector(cfgs, device="cpu", timeout=TIMEOUT, **kw)


class Record:
    """Each lane's valid outputs and sample indices over a run's drains."""

    def __init__(self, lanes):
        self.outs = [[] for _ in range(lanes)]
        self.idx = [[] for _ in range(lanes)]

    def add(self, out, bank):
        for lane in range(len(self.outs)):
            c = int(bank.last_counts[lane])
            self.outs[lane].append(np.asarray(out)[lane, :c])
            self.idx[lane].append(np.asarray(bank.last_sample_indices[lane]))

    def assert_equal(self, other, rtol=RTOL, atol=ATOL):
        for lane in range(len(self.outs)):
            got, want = np.concatenate(self.outs[lane]), np.concatenate(other.outs[lane])
            np.testing.assert_array_equal(np.concatenate(self.idx[lane]),
                                          np.concatenate(other.idx[lane]))
            assert got.shape == want.shape and len(got)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def reaped(r):
    proc = r._proc
    r.close()
    return proc is None or not proc.is_alive()


@pytest.mark.parametrize("method", ["matmul", "fused"])
def test_crash_recovery(cfgs, method):
    """The child dies mid-stream with undrained journal entries; the
    restarted child continues the stream exactly."""
    x = fixtures.chirp_audio(0.6, 13)
    chunks = [x[i : i + 5000] for i in range(0, len(x), 5000)]
    oracle = (jax_bank(cfgs[:1]) if method == "matmul"
              else DetectorBank(cfgs[:1], method="fused", device="cpu"))
    want, got = Record(1), Record(1)
    r = resilient(cfgs[0], method=method)
    try:
        for k, chunk in enumerate(chunks):
            oracle.append_audio_data(0, chunk)
            want.add(oracle.drain(), oracle)
            r.append_audio_data(chunk)
            if k == 2:
                r.crash_for_test()
            got.add(r.drain(), r)
        assert r.restarts >= 1
        # the child's own kernel counts: on the CPU every entry runs its
        # plain version, which counts no launch
        launches = r.kernel_launches()
        assert {"single", "batch", "program int16", "program mulaw8"} <= set(launches)
        assert not any(launches.values())
    finally:
        assert reaped(r)
    got.assert_equal(want, *((RTOL, ATOL) if method == "matmul" else (1e-6, 1e-6)))


def test_multi_lane_and_limit(cfgs):
    x = fixtures.chirp_audio(0.3, 14)
    oracle, want, got = jax_bank(cfgs), Record(2), Record(2)
    r = resilient(cfgs, max_restarts=1)
    try:
        for lane in range(2):
            r.append_audio_data(x, lane=lane)
            oracle.append_audio_data(lane, x)
        got.add(r.drain(), r)
        want.add(oracle.drain(), oracle)
        r.crash_for_test()  # one crash recovers within max_restarts=1
        for lane in range(2):
            r.append_audio_data(x[::-1].copy(), lane=lane)
            oracle.append_audio_data(lane, x[::-1].copy())
        got.add(r.drain(), r)
        want.add(oracle.drain(), oracle)
        assert r.restarts == 1
    finally:
        assert reaped(r)
    got.assert_equal(want)


def test_append_exactly_once_on_crash(cfgs):
    """A child that dies before an append arrives: the restart's replay
    applies the journaled chunk once and the request is not re-sent."""
    x = fixtures.chirp_audio(0.4, 15)
    oracle, want, got = jax_bank(cfgs[:1]), Record(1), Record(1)
    r = resilient(cfgs[0])
    try:
        for part in (x[:8000], x[8000:]):
            oracle.append_audio_data(0, part)
            want.add(oracle.drain(), oracle)
        r.append_audio_data(x[:8000])
        got.add(r.drain(), r)
        r._proc.terminate()
        r._proc.join(timeout=10)
        r.append_audio_data(x[8000:])
        got.add(r.drain(), r)
        assert r.restarts >= 1
    finally:
        assert reaped(r)
    got.assert_equal(want)


def test_semantic_error_no_respawn(cfgs):
    """A bad request raises DetectorChildError at once; no restart, and the
    child keeps serving."""
    r = resilient(cfgs[0])
    try:
        bad_state = {"segments": [[], []], "offered": [0, 0], "hops_emitted": [0, 0],
                     "last_outputs": np.zeros((2, 1), np.float32),
                     "overflows": [0, 0], "dropped_samples": [0, 0]}
        with pytest.raises(DetectorChildError, match="lanes"):
            r._supervised(("set_state", bad_state))
        assert r.restarts == 0
        r.append_audio_data(fixtures.chirp_audio(0.2, 17))
        assert r.drain().shape[1] > 0
    finally:
        assert reaped(r)


def test_journal_gap_markers_bounded(cfgs):
    """Chunks the child bank would drop at its cap are journaled as data-free
    gap markers, and a crash replay keeps the bank's gap accounting."""
    x1, x2, x3 = (fixtures.chirp_audio(0.2, s) for s in (18, 19, 20))
    oracle = jax_bank(cfgs[:1], max_buffer_seconds=0.3)
    want, got = Record(1), Record(1)
    oracle.append_audio_data(0, x1)
    assert not oracle.append_audio_data(0, x2)
    want.add(oracle.drain(), oracle)
    oracle.append_audio_data(0, x3)
    want.add(oracle.drain(), oracle)
    r = resilient(cfgs[0], max_buffer_seconds=0.3)
    try:
        r.append_audio_data(x1)
        r.append_audio_data(x2)  # beyond the mirrored cap: a gap marker
        assert [e for e in r._journal if e[0] == "gap"] == [("gap", 0, len(x2))]
        got.add(r.drain(), r)
        r.crash_for_test()
        r.append_audio_data(x3)
        got.add(r.drain(), r)
        assert r.restarts >= 1
    finally:
        assert reaped(r)
    got.assert_equal(want)


def test_warm_up_keeps_journal_consistent(cfgs):
    """append, warm_up, crash, drain: the pre-warm-up audio is applied once
    (warm_up's snapshot already holds it)."""
    x = fixtures.chirp_audio(0.3, 16)
    oracle, want, got = jax_bank(cfgs[:1]), Record(1), Record(1)
    oracle.append_audio_data(0, x)
    want.add(oracle.drain(), oracle)
    r = resilient(cfgs[0])
    try:
        r.append_audio_data(x)
        assert r.warm_up(buckets=(8,)) == 1
        r.crash_for_test()
        got.add(r.drain(), r)
        assert r.restarts >= 1
    finally:
        assert reaped(r)
    got.assert_equal(want)


def test_handshake_failure_kills_child(cfgs, monkeypatch):
    """A failed or hung handshake reaps the spawned child: the exception
    leaves __init__, so close() could never run."""
    killed = []
    orig_kill = rmod.ResilientDetector._kill_child

    def spy_kill(self):
        killed.append(self._proc)
        orig_kill(self)

    def hung_recv(self):
        raise TimeoutError("simulated hung handshake")

    monkeypatch.setattr(rmod.ResilientDetector, "_recv", hung_recv)
    monkeypatch.setattr(rmod.ResilientDetector, "_kill_child", spy_kill)
    with pytest.raises(TimeoutError):
        ResilientDetector(cfgs[0], device="cpu", timeout=5.0)
    assert killed and killed[0] is not None
    killed[0].join(timeout=10)
    assert not killed[0].is_alive()


def test_handshake_without_card_is_fatal(cfgs):
    """A child asked for a card that is absent fails its handshake (it does
    not move to the CPU), and is reaped."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the child would start on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResilientDetector(cfgs[0], timeout=TIMEOUT)


def test_interleaved_api_with_gap_and_crash(cfgs):
    """Interleaved capture and an interleaved-stream gap through the
    supervisor match DetectorBank's semantics, across a crash (the parent's
    de-interleave carry and the journaled gap markers replay)."""
    a, b = fixtures.chirp_audio(0.25, 23), fixtures.chirp_audio(0.25, 24)
    pre = np.empty(2 * len(a), np.float32)
    pre[0::2], pre[1::2] = a, b
    post = np.empty_like(pre)
    post[0::2], post[1::2] = b, a
    n_lost = 2 * 1500
    oracle, want, got = jax_bank(cfgs), Record(2), Record(2)
    oracle.append_interleaved_audio_data(pre[:-1])  # odd: a carry pending
    want.add(oracle.drain(), oracle)
    oracle.note_interleaved_gap(n_lost)
    oracle.append_interleaved_audio_data(post)
    want.add(oracle.drain(), oracle)
    r = resilient(cfgs)
    try:
        r.append_interleaved_audio_data(pre[:-1])
        got.add(r.drain(), r)
        r.note_interleaved_gap(n_lost)
        r.crash_for_test()  # the gap marker and the carry survive the respawn
        r.append_interleaved_audio_data(post)
        got.add(r.drain(), r)
        assert r.restarts >= 1
    finally:
        assert reaped(r)
    got.assert_equal(want)
