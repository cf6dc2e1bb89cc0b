"""The training phases of ``chip_smoke.py`` (16 and 17) alone.

Phase 16 trains through the port's main path on the card (the train CLI at
its defaults on a 60 s labeled file, the 16-channel ensemble, the meshes,
resume) and phase 17 times it; see ``chip_smoke.py``'s docstring for what
each line holds. Without the other phases this takes about a minute and a
half on an H100, so two checkouts can be compared in one chip run, in
turns. Run it from the root of a checkout of the port (it imports that
checkout's ``chip_smoke``), on a machine with one CUDA card:

    PYTHONPATH=. python3 path/to/train_phases.py

It prints the card's name and power limit, the versions, each phase's lines
and each phase's wall; it exits non-zero where a phase fails and, like
``chip_smoke.py``, without a card.
"""

from __future__ import annotations

import sys
import tempfile
import time

import torch

import chip_smoke


def main() -> int:
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = chip_smoke.card()
    print(card_line, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        trained = chip_smoke.phase_train(tmp)
        t1 = time.perf_counter()
        chip_smoke.phase_train_times(trained, card_line)
        t2 = time.perf_counter()
    print(f"train_phases walls: phase 16 {t1 - t0:.1f} s, phase 17 {t2 - t1:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
