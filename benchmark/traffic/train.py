"""Training traffic: ``train.main`` at its defaults, run after run.

Set-up writes one labeled ``audio_seconds`` WAV (float32) and its interval
CSV into the run's TMPDIR, made from the seed as the port's smoke makes
them, and runs ``train.main`` once for ``warm_epochs`` epochs. The window
runs ``train.main`` on them with the configuration's geometry flags, the
seed of the run and ``--quiet``, run after run; the run in flight at the
deadline is finished and counted. A wrapper around the trainer's epoch loop
keeps every optimizer step's losses from the epoch's values; each run's
losses over its first ``compare_epochs`` epochs (several replays of the
epoch graph and the shuffles at their boundaries) are held against the
plain trainer's (``reference/train.py``), which trains that far.
"""

from __future__ import annotations

import contextlib
import io
import os
import tempfile
import time

import numpy as np
import torch

from benchmark import harness, program, synth
from benchmark.reference import train as ref

def _paths(run) -> tuple[str, str, str]:
    folder = os.path.join(tempfile.gettempdir(), "sd_benchmark", run.cell)
    return (os.path.join(folder, "song.wav"), os.path.join(folder, "labels.csv"),
            os.path.join(folder, "net_{k}.txt"))


def _argv(run, wav, csv, out, epochs=None) -> list[str]:
    p = run.params
    return ["-a", wav, "-l", csv, "-o", out, "--seed", str(run.seed), "--quiet",
            "--device", str(run.device), "--epochs", str(epochs or p["epochs"]),
            "--batch-size", str(p["batch"]), "--learning-rate", repr(p["learning_rate"]),
            *program.geometry_flags(run.geom)]


def setup(run):
    p = run.params
    rate = int(run.geom["sampling_rate"])
    audio, intervals = synth.labeled_audio(p["audio_seconds"], rate, run.seed)
    wav, csv, out = _paths(run)
    os.makedirs(os.path.dirname(wav), exist_ok=True)
    synth.write_wav_f32(wav, audio, rate)
    with open(csv, "w") as fh:
        fh.write("# start,end\n" + "".join(f"{lo!r},{hi!r}\n" for lo, hi in intervals))
    state = {"audio": audio, "intervals": intervals, "wav": wav, "csv": csv, "out": out,
             "losses": [], "steps": 0}
    _main(run, state, _argv(run, wav, csv, out.format(k="warm"), p["warm_epochs"]))
    state["losses"].clear()
    state["steps"] = 0
    return state


@contextlib.contextmanager
def _epoch_values(state):
    """Inside ``with``: each run of the trainer's epoch loop counts its
    optimizer steps and keeps the losses of its first steps."""
    from syllable_detector_tpu_torch.training import trainer

    loop = trainer._run_training_loop

    def counted(settings, epoch_fn, data, epoch_indices, params, opt_state, *rest):
        first = []

        def epochs(*args):
            state["steps"] += args[-1].shape[0]
            out = epoch_fn(*args)
            first.append(out[-1].clone())
            return out

        result = loop(settings, epochs, data, epoch_indices, params, opt_state, *rest)
        state["losses"].append(torch.cat(first) if first else None)
        return result

    trainer._run_training_loop = counted
    try:
        yield
    finally:
        trainer._run_training_loop = loop


def _main(run, state, argv) -> None:
    from syllable_detector_tpu_torch import train as train_cli

    err = io.StringIO()
    with _epoch_values(state), contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = train_cli.main(argv)
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"train.main returned {rc}: {err.getvalue()[-2000:]}")


def window(run, state, seconds: float) -> dict:
    from syllable_detector_tpu_torch import train as train_cli
    from syllable_detector_tpu_torch.training import trainer

    from benchmark.trace import DeviceTrace

    spans = []
    if run.trace:
        spans = [run.spans.around(train_cli, "train", "train.trainer"),
                 run.spans.around(train_cli, "features_and_labels", "train.features"),
                 run.spans.around(train_cli, "save_config", "train.export"),
                 run.spans.around(trainer, "_run_training_loop", "trainer.epochs")]
    outs = []
    with contextlib.ExitStack() as stack:
        for s in spans:
            stack.enter_context(s)
        if run.trace:
            # the device trace covers one run ahead of the window: a run is
            # some 1.6 million kernels, whose events take a minute to read
            outs.append(state["out"].format(k="traced"))
            with DeviceTrace() as run.device_trace:
                _main(run, state, _argv(run, state["wav"], state["csv"], outs[-1]))
            run.work["traced_steps"], state["steps"] = state["steps"], 0
        t0 = time.perf_counter()
        run.setup_s = t0 - run.t_start
        while True:
            outs.append(state["out"].format(k=len(outs)))
            a = time.perf_counter()
            _main(run, state, _argv(run, state["wav"], state["csv"], outs[-1]))
            t1 = time.perf_counter()
            harness.note(run, f"run {len(outs)}: {t1 - a:.4f} s")
            if t1 - t0 >= seconds:
                break
    run.window = (t0, t1)
    run.work.update(steps=state["steps"], batch=run.params["batch"],
                    nets=run.params["inits"])
    runs = len(outs) - run.trace
    return {"metrics": {"train_run_s": (t1 - t0) / runs}, "attempted": len(outs),
            "failed": 0, "produced": {"losses": state["losses"]}}


def release(run, state) -> None:
    state["losses"][:] = [None if v is None else v.cpu().numpy() for v in state["losses"]]


def reference(run, state, precision: str = "float32", trainer=ref.Trainer) -> np.ndarray:
    """The plain trainer's losses [steps, inits] over the first
    ``compare_epochs`` epochs."""
    p = run.params
    t = trainer(run.geom, state["audio"], state["intervals"], run.seed, run.device,
                precision, p["inits"], p["batch"])
    return t.run(min(p["compare_epochs"], p["epochs"]), p["learning_rate"])


def step_gaps(losses, want: np.ndarray) -> np.ndarray:
    """Each step's widest loss gap over the inits, relative to the plain
    trainer's loss, over the steps ``want`` holds."""
    n = min(len(losses), len(want))
    return np.max(np.abs(np.asarray(losses[:n], np.float64) - want[:n]) / want[:n], axis=1)


def epoch_median_gap(gaps: np.ndarray, steps: int) -> float:
    """The widest, over the epochs, of the median step gap within an epoch:
    a fault in any one replay moves its epoch's median, and a few steps at
    which Adam turns round-off into a whole step do not."""
    return float(np.median(gaps.reshape(-1, steps), axis=1).max())


def compare(run, state, produced) -> dict:
    """Every run of the window against the plain trainer along the first
    ``compare_epochs`` epochs (:func:`step_gaps`): ``loss_gap_first_epoch``,
    the median step gap of the first epoch (the first replay), which sound
    runs hold steady; and ``loss_gap_epoch_median``, the widest epoch
    median, which rounding moves more from epoch to epoch and a replay gone
    wrong far more."""
    want = state.get("reference")
    if want is None:
        want = state["reference"] = reference(run, state)
    steps = len(want) // min(run.params["compare_epochs"], run.params["epochs"])
    numbers = {"loss_gap_first_epoch": 0.0, "loss_gap_epoch_median": 0.0}
    for losses in produced["losses"]:
        if losses is None or len(losses) < len(want):
            return {k: float("inf") for k in numbers}
        gaps = step_gaps(losses, want)
        numbers["loss_gap_first_epoch"] = max(numbers["loss_gap_first_epoch"],
                                              float(np.median(gaps[:steps])))
        numbers["loss_gap_epoch_median"] = max(numbers["loss_gap_epoch_median"],
                                               epoch_median_gap(gaps, steps))
    return numbers


def control(run, state, seconds: float):
    """The plain trainer's losses in TF32, as one run's."""
    return {"losses": [reference(run, state, "tf32")]}
