"""Readings that set a cell's limits: its numbers on many seeds in one
process, for the program, for the control, or for a planted fault.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 5 \\
        --mode program|control|fault:<name>|look [--epochs 20]

``program`` runs the cell as ``run.py`` does (a window of ``--seconds``);
``control`` puts the plain reference, one precision lower (TF32 products),
in the program's place and compares it as the program's output is
compared; ``fault:<name>`` runs the program with a fault of ``faults.py``
planted underneath. One JSON line a seed: ``{"seed", "mode", "correct",
"numbers"}``. ``look`` (training cells) follows the loss gap along
``--epochs`` epochs instead (:func:`train_look`). The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import faults, harness  # noqa: E402


def reading(cell: str, seed: int, seconds: float, mode: str, device="cuda",
            workload: dict | None = None) -> dict:
    """The numbers one seed gives under ``mode``."""
    if mode == "control":
        run, driver = harness.start(cell, seed, False, device, time.perf_counter(), workload)
        state = driver.setup(run)
        driver.release(run, state)
        checks = harness.checks_of(run, driver.compare(run, state,
                                                       driver.control(run, state, seconds)))
    else:
        hooks = None
        if mode.startswith("fault:"):
            kind = (workload or harness.load_json("workloads", cell))["traffic"]
            hooks = faults.FAULTS[kind][mode.split(":", 1)[1]]()
        _, checks = harness.run_cell(cell, seed, seconds, False, device, hooks=hooks,
                                     workload=workload)
    return {"seed": seed, "mode": mode, "correct": harness.passed(checks),
            "numbers": {name: value for name, value, _ in checks}}


HORIZONS = (1, 2, 3, 5, 10, 20, 50, 100, 300)  # epochs
APART = 1e-3  # a relative loss gap at which two trainers have parted


def summary(curve: np.ndarray, steps: int, epoch_median_gap) -> dict:
    """Up to each horizon the curve reaches, the widest gap and the widest
    epoch median (``epoch_median_gap``), and the first step at which the
    gap passes ``APART`` (the curve's length where it never does)."""
    apart = np.flatnonzero(curve > APART)
    ends = [e for e in HORIZONS if e * steps <= len(curve)]
    return {"up_to_epoch": {e: float(curve[: e * steps].max()) for e in ends},
            "epoch_median_up_to_epoch": {e: epoch_median_gap(curve[: e * steps], steps)
                                         for e in ends},
            "first_step_apart": int(apart[0]) if len(apart) else len(curve)}


def train_look(cell: str, seed: int, seconds: float, epochs: int, device="cuda",
               workload: dict | None = None) -> dict:
    """The training cell's loss gap along ``epochs`` epochs of one seed:
    the program's first run in a window of ``seconds``, the control (the
    plain trainer in TF32) and two witnesses (the plain trainer with each
    batch's rows in reverse order, the same sums in another order; and the
    plain trainer in float64), each against the plain trainer:
    :func:`summary` of its step gaps."""
    from benchmark.reference import train as ref_train

    class Reversed(ref_train.Trainer):
        def step(self, rows, bc1, bc2):
            return super().step(rows.flip(0), bc1, bc2)

    workload = copy.deepcopy(workload or harness.load_json("workloads", cell))
    workload["traffic_params"]["compare_epochs"] = epochs
    run, driver = harness.start(cell, seed, False, device, time.perf_counter(), workload)
    state = driver.setup(run)
    produced = driver.window(run, state, seconds)["produced"]
    driver.release(run, state)
    want = driver.reference(run, state)
    steps = len(want) // epochs
    curves = {"program": driver.step_gaps(produced["losses"][0], want),
              "control": driver.step_gaps(driver.reference(run, state, "tf32"), want),
              "witness": driver.step_gaps(driver.reference(run, state, trainer=Reversed), want),
              "float64": driver.step_gaps(driver.reference(run, state, "float64"), want)}
    return {"seed": seed, "mode": "look", "steps_an_epoch": steps,
            **{k: summary(c, steps, driver.epoch_median_gap) for k, c in curves.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--mode", default="control")
    p.add_argument("--epochs", type=int, default=20)
    args = p.parse_args(argv)
    harness.few_threads()
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "look":
            line = train_look(args.workload, seed, args.seconds, args.epochs)
        else:
            line = reading(args.workload, seed, args.seconds, args.mode)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
