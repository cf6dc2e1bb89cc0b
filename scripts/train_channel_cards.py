"""The ensemble trainer on a channel mesh of one shard a card, against the
unsharded ensemble on card 0.

Eight labeled channels (``make_labeled_audio``, ``SECONDS`` each, seeds
100-107) train for 3 epochs unsharded, then on ``make_mesh(axis="channel")``
(one shard per visible card) one epoch a call (verbose), where each shard
captures its own epoch graph on its own card and replays it once an epoch.
It checks: every shard captured once and replayed once an epoch (a shard's
channels are kept on its card from call to call, so no call captures
again), the sharded nets within 1e-4 of the unsharded ones, and the results
gathered on card 0. Run from the root of the repository, on a machine with
several CUDA cards:

    PYTHONPATH=. python3 scripts/train_channel_cards.py [SECONDS]

It prints the mesh, the graph counts and the largest difference, and exits
non-zero where a check fails or without a card.
"""

from __future__ import annotations

import contextlib
import io
import sys

import torch

from syllable_detector_tpu_torch.parallel import mesh as pmesh
from syllable_detector_tpu_torch.training import trainer
from syllable_detector_tpu_torch.utils.synth import make_labeled_audio

CHANNELS = 8
EPOCHS = 3


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("train_channel_cards: no CUDA device is available", file=sys.stderr)
        return 1
    seconds = float(argv[0]) if argv else 20.0
    torch.backends.cuda.matmul.allow_tf32 = False
    settings = trainer.TrainSettings(epochs=EPOCHS, batch_size=256, learning_rate=3e-3)
    data = [trainer.features_and_labels(settings, *make_labeled_audio(seconds, seed=100 + c),
                                        device="cuda") for c in range(CHANNELS)]
    feats, labels = [f for f, _ in data], [l for _, l in data]
    _, whole, _ = trainer.train_ensemble(settings, feats, labels, device="cuda")
    mesh = pmesh.make_mesh(axis="channel")
    trainer.EPOCH_GRAPHS = {"captures": 0, "replays": 0}
    with contextlib.redirect_stdout(io.StringIO()):
        _, sharded, _ = trainer.train_ensemble(settings, feats, labels, mesh=mesh, verbose=True)
    graphs = dict(trainer.EPOCH_GRAPHS)
    worst = max(float((a.cpu() - b.cpu()).abs().max())
                for x, y in zip(sharded, whole)
                for a, b in zip(pmesh._leaves(x), pmesh._leaves(y)))
    print(f"mesh {mesh}; epoch graphs {graphs} over {EPOCHS} one-epoch calls; sharded vs "
          f"unsharded max abs {worst:.3g}", flush=True)
    shards = len(mesh.devices)
    if graphs != {"captures": shards, "replays": EPOCHS * shards}:
        raise AssertionError(f"epoch graphs {graphs} for {shards} shards and {EPOCHS} epochs")
    if worst >= 1e-4:
        raise AssertionError(f"sharded vs unsharded max abs {worst}")
    if {x["layers"][0]["w"].device for x in sharded} != {mesh.devices[0]}:
        raise AssertionError("the sharded nets are not gathered on shard 0's card")
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
