"""The trainer on a data mesh of one shard a card, against unsharded
training on card 0.

A labeled ``SECONDS`` s file (``make_labeled_audio``, seed 31) trains a net
at the train CLI's defaults (batch 256, lr 3e-3, 4 inits) for ``EPOCHS``
epochs unsharded on card 0, then on ``make_mesh(axis="data")`` (one shard
per visible card) one epoch a call (verbose). On one card the mesh has one
shard and each epoch is one replay of its epoch graph; on several, each
step replays a graph of its shard's gradients on every card and a graph of
the shard-order sum and the Adam update on card 0. It checks: the graphs
captured once (one card: 1; n cards: n + 1) and replayed once an epoch (one
card) or once a step each (n cards: n + 1 a step), the mesh's nets within
rtol=1e-4, atol=1e-5 of the unsharded ones and its threshold within 1e-5,
the results on card 0. Then it times the training loop of the mesh's
per-step route (``epoch.plain``) and of its graphs at ``TIMED_EPOCHS``
epochs, in turns (plain, graph, graph, plain): wall and steps per second;
each route's two runs must give the same net bit for bit, and the graphs'
net the plain route's bit for bit, or else within rtol=1e-6, atol=1e-7
(the largest difference printed).
Run from the root of the repository, on a machine with one CUDA card or
several:

    PYTHONPATH=. python3 scripts/train_data_cards.py [SECONDS]

It prints every card's name and power limit, the mesh, the graph counts,
the largest difference and the times, and exits non-zero where a check
fails or without a card.
"""

from __future__ import annotations

import contextlib
import io
import subprocess
import sys

import torch

from chip_smoke import TrainSpy, graph_against_plain, plain_epochs, same_bits
from syllable_detector_tpu_torch.parallel import mesh as pmesh
from syllable_detector_tpu_torch.training import trainer
from syllable_detector_tpu_torch.utils.synth import make_labeled_audio

EPOCHS = 3
TIMED_EPOCHS = 30


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("train_data_cards: no CUDA device is available", file=sys.stderr)
        return 1
    seconds = float(argv[0]) if argv else 60.0
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    settings = trainer.TrainSettings(epochs=EPOCHS, batch_size=256, learning_rate=3e-3)
    feats, labels = trainer.features_and_labels(
        settings, *make_labeled_audio(seconds, seed=31), device="cuda")
    _, whole, t_whole = trainer.train(settings, feats, labels, device="cuda")
    mesh = pmesh.make_mesh(axis="data")
    cards = len(set(mesh.devices))
    trainer.EPOCH_GRAPHS = {"captures": 0, "replays": 0}
    with contextlib.redirect_stdout(io.StringIO()), TrainSpy() as spy:
        _, sharded, t_sharded = trainer.train(settings, feats, labels, mesh=mesh, verbose=True)
    graphs = dict(trainer.EPOCH_GRAPHS)
    steps = spy.runs[0]["steps"]
    worst = max(float((a.cpu() - b.cpu()).abs().max())
                for a, b in zip(pmesh._leaves(sharded), pmesh._leaves(whole)))
    print(f"mesh {mesh}; {len(feats)} evaluations, {steps} steps over {EPOCHS} one-epoch calls; "
          f"graphs {graphs}; sharded vs unsharded params max abs {worst:.3g}, thresholds "
          f"{t_sharded:.6f} / {t_whole:.6f}", flush=True)
    want = ({"captures": 1, "replays": EPOCHS} if cards == 1
            else {"captures": cards + 1, "replays": (cards + 1) * steps})
    if graphs != want:
        raise AssertionError(f"graphs {graphs} for {cards} card(s), {EPOCHS} epochs, {steps} steps")
    for a, b in zip(pmesh._leaves(sharded), pmesh._leaves(whole)):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-5)
    if abs(t_sharded - t_whole) > 1e-5:
        raise AssertionError(f"thresholds {t_sharded} / {t_whole}")
    if {t.device for t in pmesh._leaves(sharded)} != {mesh.devices[0]}:
        raise AssertionError("the sharded net is not on shard 0's card")

    timed = trainer.TrainSettings(epochs=TIMED_EPOCHS, batch_size=256, learning_rate=3e-3)
    times, nets = {}, []
    for name in ("plain", "graph", "graph", "plain"):
        with TrainSpy() as spy, (plain_epochs() if name == "plain" else contextlib.nullcontext()):
            nets.append(trainer.train(timed, feats, labels, mesh=mesh)[1])
        run = spy.runs[0]
        times.setdefault(name, []).append((run["wall"], run["steps"] / run["wall"]))
    verdict = graph_against_plain(nets[1], nets[0], "the graphs' net against the plain route's")
    if not (same_bits(nets[2], nets[1]) and same_bits(nets[3], nets[0])):
        raise AssertionError("two timed runs of one route gave other nets")
    print(f"training loop, {TIMED_EPOCHS} epochs ({spy.runs[0]['steps']} steps) on {mesh}, "
          f"plain, graph, graph, plain: "
          + "; ".join(f"{name} " + ", ".join(f"{w:.3f} s ({r:.1f} steps/s)" for w, r in walls)
                      for name, walls in times.items())
          + f"; the graphs' nets against the plain route's: {verdict}", flush=True)
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
