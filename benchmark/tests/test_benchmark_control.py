"""The control, the plain reference one precision lower (TF32 products),
must come out not correct in every cell, and the faults planted under the
timed path must make ``correct`` false, at a size a test run holds."""

import pytest

from benchmark import control, faults, harness

from benchmark.tests.small import SECONDS, workload

CELLS = sorted(SECONDS)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    r = control.reading(cell, 2**31 + 7, SECONDS[cell], "program", "cpu", workload(cell))
    assert r["correct"], r


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.reading(cell, 2**31 + 8, SECONDS[cell], "control", "cpu", workload(cell))
    assert not r["correct"], r


FAULT_CASES = [(cell, name) for cell in CELLS
               for name in faults.FAULTS[harness.load_json("workloads", cell)["traffic"]]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_fault_is_not_correct(cell, fault):
    r = control.reading(cell, 2**31 + 9, SECONDS[cell], f"fault:{fault}", "cpu",
                        workload(cell))
    assert not r["correct"], r


def test_look_follows_the_training_loss_gap():
    """The look's readings: the program and the reordered plain trainer
    stay within both of the cell's limits along every epoch, and the TF32
    control fails the first epoch's."""
    wl = workload("train_sample_defaults")
    first, epochs = (wl["limits"][k] for k in ("loss_gap_first_epoch", "loss_gap_epoch_median"))
    r = control.train_look("train_sample_defaults", 2**31 + 21, 0.2, 3, "cpu", wl)
    for who in ("program", "control", "witness", "float64"):
        assert list(r[who]["up_to_epoch"]) == [1, 2, 3]
    for who in ("program", "witness"):
        assert r[who]["epoch_median_up_to_epoch"][1] <= first
        assert max(r[who]["epoch_median_up_to_epoch"].values()) <= epochs
    assert r["control"]["epoch_median_up_to_epoch"][1] > first
