"""Neither the reference nor anything a run loads has a top-level module
named ``jax``, ``jaxlib``, ``flax`` or ``syllable_detector_tpu`` (the JAX
package; compared whole, since the port's name begins with it)."""

import subprocess
import sys

from benchmark import harness

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from benchmark import harness, control, faults
from benchmark.reference import detect, train
from benchmark.tests.small import SECONDS, workload
for m in harness.benchmark_spec()["per_layer"]:
    harness.load_module("metrics", m["name"])
for cell in SECONDS:
    harness.run_cell(cell, 2**31 + 21, SECONDS[cell], False, "cpu", workload=workload(cell))
print("LOADED", sorted({{n.split(".")[0] for n in sys.modules}}))
print("BANNED", harness.banned_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(harness.CHECKOUT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "BANNED")))
    assert lines["BANNED"] == "[]"
    assert "syllable_detector_tpu_torch" in lines["LOADED"]


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "syllable_detector_tpu_torch_x", sys)
    assert "syllable_detector_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "syllable_detector_tpu.cli", sys)
    assert harness.banned_modules() == ["syllable_detector_tpu"]
