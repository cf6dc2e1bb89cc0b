"""The hop-latency and lateness arithmetic of the live cell on a fake clock."""

import numpy as np
import pytest

from benchmark.traffic.live import Recorder, Schedule, latencies, tail

FIRST, STEP, BLOCK, RATE = 1444, 132, 128, 44100.0


class Bank:
    """What the recorder reads of a drained bank."""

    def __init__(self, per_lane):
        self.last_sample_indices = [np.asarray(i, np.int64) for i in per_lane]
        self.last_counts = np.array([len(i) for i in per_lane], np.int64)

    def out(self):
        n = max(self.last_counts.max(), 1)
        o = np.zeros((len(self.last_counts), n, 1), np.float32)
        for j, idx in enumerate(self.last_sample_indices):
            o[j, : len(idx), 0] = idx  # an output that names its hop
        return o


def hop(k):
    return FIRST + STEP * k


def test_latency_runs_from_the_block_due_to_the_hand_over():
    sched = Schedule(anchor=100.0, block=BLOCK, rate=RATE, first=0, end=1000)
    rec = Recorder(lanes=2, hops=3, rounds=4, first=FIRST, step=STEP)
    bank = Bank([[hop(0), hop(1)], [hop(0)]])
    rec.drained(bank, bank.out(), 101.0, 101.001)
    rec.stamps[:] = [101.002, np.nan]  # lane 1 not handed over: the round's last
    bank = Bank([[hop(2)], [hop(1), hop(2)]])
    rec.drained(bank, bank.out(), 101.010, 101.011)
    rec.stamps[:] = [101.012, 101.013]
    rec.close()
    lat, attempted, failed = latencies(rec, sched, deadline=1e9)
    assert (attempted, failed, rec.bad) == (6, 0, 0)
    blocks = (np.array([hop(k) for k in range(3)]) - 1) // BLOCK
    due = 100.0 + (blocks + 1) * BLOCK / RATE
    want = np.array([101.002 - due[0], 101.002 - due[1], 101.012 - due[2],
                     101.002 - due[0], 101.013 - due[1], 101.013 - due[2]]) * 1e3
    np.testing.assert_allclose(lat, want)
    np.testing.assert_array_equal(rec.outs, [[hop(0), hop(1), hop(2)]] * 2)


def test_dropped_undecided_and_late_hops_are_failed():
    sched = Schedule(anchor=0.0, block=BLOCK, rate=RATE, first=0, end=1000)
    rec = Recorder(lanes=2, hops=4, rounds=4, first=FIRST, step=STEP)
    bank = Bank([[hop(0), hop(1)], [hop(0), hop(2)]])  # lane 1 drops hop 1
    rec.drained(bank, bank.out(), 1.0, 1.0)
    rec.stamps[:] = [1.0, 1.0]
    bank = Bank([[hop(2)], []])
    rec.drained(bank, bank.out(), 9.0, 9.0)  # after the deadline
    rec.stamps[:] = [9.0, np.nan]
    rec.close()
    lat, attempted, failed = latencies(rec, sched, deadline=5.0)
    # 8 due; decided in time: lane 0 hops 0, 1, lane 1 hops 0, 2; lane 0 hop
    # 2 late; lane 1 hop 1 dropped; hop 3 of both never decided
    assert (attempted, failed, len(lat)) == (8, 4, 4)
    assert tail(lat, failed, 50) == np.inf
    assert np.isfinite(tail(lat, failed, 40))


def test_hops_outside_the_window_and_off_the_grid():
    sched = Schedule(anchor=0.0, block=BLOCK, rate=RATE, first=12, end=14)
    rec = Recorder(lanes=1, hops=3, rounds=2, first=FIRST, step=STEP)
    bank = Bank([[hop(0), hop(1) + 1, hop(2)]])  # hop 1 at a sample off the grid
    rec.drained(bank, bank.out(), 1.0, 1.0)
    rec.close()
    lat, attempted, failed = latencies(rec, sched, deadline=5.0)
    # blocks of hops 0, 1, 2: 11, 12, 13 -> hops 1 and 2 are in the window
    assert [(hop(k) - 1) // BLOCK for k in range(3)] == [11, 12, 13]
    assert (attempted, failed, rec.bad) == (2, 1, 1)


def test_a_hop_decided_twice_counts_against_the_index():
    rec = Recorder(lanes=1, hops=2, rounds=3, first=FIRST, step=STEP)
    for _ in range(2):
        bank = Bank([[hop(0)]])
        rec.drained(bank, bank.out(), 1.0, 1.0)
    assert rec.bad == 1


@pytest.mark.parametrize("q", [50, 95])
def test_tail_is_a_percentile_of_every_hop(q):
    # the hop at rank ceil(q% of n - 1), no interpolation between hops
    lat = np.arange(1, 102, dtype=float)
    assert tail(lat, 0, q) == float(q + 1)
    assert tail(lat[:-1], 1, q) == float(q + 1)  # a failed hop ranks last
