"""One run of one cell: set-up, the timed window, the checks, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

- ``configs/<config>.json``: the geometry, net widths and precision;
- ``workloads/<cell>.json``: the cell's configuration, its traffic kind,
  the traffic's parameters and the limits of its correctness numbers;
- ``traffic/<kind>.py``: the driver of a traffic kind, with ``setup``,
  ``window``, ``release``, ``compare`` and ``control``;
- ``metrics/<metric>.py``: the reader of a per-layer metric, ``read(run)``,
  which returns a number or None where it finds nothing to read.

``BENCHMARK.json`` at the checkout's root names each cell's metrics.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# top-level module names that the process may not hold once the window has
# closed: JAX, its libraries, and the JAX package (compared whole: the
# port's name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "syllable_detector_tpu")


def note(run, what: str) -> None:
    """A line on standard error: seconds since the run started, and what."""
    print(f"{time.perf_counter() - run.t_start:8.3f} s  {what}", file=sys.stderr, flush=True)


class NoCard(RuntimeError):
    """The run found fewer CUDA cards than its cell asks for."""


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of this folder as a module."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    key = f"benchmark_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def benchmark_spec() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key] if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Run:
    """What a driver and the metric readers share about one run."""

    cell: str
    workload: dict
    geom: dict
    seed: int
    device: object
    trace: bool
    t_start: float
    spans: object = None
    device_trace: object = None
    window: tuple = (0.0, 0.0)
    work: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0

    @property
    def params(self) -> dict:
        return self.workload["traffic_params"]


def few_threads() -> None:
    """One worker thread for the CPU thread pools of OpenMP, MKL and
    OpenBLAS, set before torch or numpy is loaded: the port's host work runs
    on its own threads, and a pool of idle workers only contends with them
    for the shared host's cores."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def prepare_environment() -> None:
    """The tuning cache at a path that does not exist under the run's
    TMPDIR, so that a ``tune.json`` elsewhere cannot move a kernel's frames
    (they are chosen by rule)."""
    os.environ["SD_TUNE_CACHE"] = os.path.join(
        tempfile.gettempdir(), "sd_benchmark_no_tune", "tune.json")


def check_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA card is available; the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} card(s), {torch.cuda.device_count()} visible")


def device_info(device, trace) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
    }
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.t1 - trace.t0
    return info


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def start(cell: str, seed: int, trace: bool, device, t_start: float,
          workload: dict | None = None) -> tuple[Run, object]:
    """The run's context and its traffic driver (``workload``: the cell's
    file, or, in tests, a dictionary in its place)."""
    from benchmark.trace import Spans

    workload = workload or load_json("workloads", cell)
    geom = load_json("configs", workload["config"])
    driver = load_module("traffic", workload["traffic"])
    run = Run(cell=cell, workload=workload, geom=geom, seed=int(seed), device=device,
              trace=trace, t_start=t_start, spans=Spans())
    return run, driver


def checks_of(run: Run, numbers: dict) -> list[tuple[str, float, float]]:
    """(name, number, limit) of every compared number; a number above its
    limit, or not a number, fails."""
    limits = run.workload["limits"]
    missing = set(limits) - set(numbers)
    if missing:
        raise RuntimeError(f"the comparison gave no {sorted(missing)}")
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]


def passed(checks) -> bool:
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, hooks=None, workload: dict | None = None
             ) -> tuple[dict, list]:
    """One run: (the result line's object, the checks). ``hooks`` and
    ``workload`` are for tests: ``hooks`` is entered around the window and
    the checks, to break the timed path underneath, and ``workload`` stands
    in for the cell's file."""
    import contextlib

    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    run, driver = start(cell, seed, trace, device, t_start, workload)
    if torch.device(device).type == "cuda":
        check_cards(run.workload.get("chips", 1))
    prepare_environment()
    with hooks or contextlib.nullcontext():
        note(run, "set-up")
        state = driver.setup(run)
        note(run, "set-up done")
        if trace and torch.device(device).type == "cuda":
            from benchmark.trace import warm_profiler

            warm_profiler()
        result = driver.window(run, state, seconds)
        note(run, f"window done ({seconds} s asked, from {run.setup_s:.3f} s)")
        if banned_modules():
            raise RuntimeError(f"the run loaded {banned_modules()}")
        info = device_info(device, run.device_trace)
        driver.release(run, state)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        numbers = driver.compare(run, state, result["produced"])
        checks = checks_of(run, numbers)
        for name in sorted(set(numbers) - set(run.workload["limits"])):
            print(f"reading {name}: {numbers[name]!r} (not compared)", file=sys.stderr)
        note(run, "checks done")
    spec = benchmark_spec()
    metrics = {}
    if trace:
        for m in cell_metrics(spec, cell, True):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out = {"breakdown": run.device_trace.breakdown(run.spans)} if run.device_trace else {}
    else:
        values = dict(result["metrics"], setup_s=run.setup_s)
        for m in cell_metrics(spec, cell, False):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        out = {}
    if banned_modules():
        raise RuntimeError(f"the run loaded {banned_modules()}")
    line = {
        "correct": passed(checks),
        "attempted": int(result["attempted"]),
        "failed": int(result["failed"]),
        "metrics": metrics,
        "device": info,
        **out,
        "checks": {name: {"value": v, "limit": lim} for name, v, lim in checks},
    }
    return line, checks
