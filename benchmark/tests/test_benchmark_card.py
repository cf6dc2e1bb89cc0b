"""A short run of each cell on the card, through ``run.py``, with its result
line; skips where there is no card."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, str(harness.ROOT / "run.py"), "--workload", cell,
                          "--seed", str(2**31 + 31), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=harness.CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


def test_no_card_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoCard):
        harness.check_cards(1)
