"""CPU tests of the benchmark: run with ``python -m pytest benchmark/tests``
from the repository's root. Tests that need a card carry the ``cuda``
marker and decide inside the test whether there is one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import tempfile  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    """Each test writes its run's files under its own TMPDIR, as each run of
    the benchmark has its own."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
