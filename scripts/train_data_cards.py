"""The trainer on a data mesh of one shard a card, against unsharded
training on card 0 and against its own per-step route.

A labeled ``SECONDS`` s file (``make_labeled_audio``, seed 31) trains a net
at the train CLI's defaults (batch 256, lr 3e-3, 4 inits) for ``EPOCHS``
epochs unsharded on card 0, then on ``make_mesh(axis="data")`` (one shard
per visible card) one epoch a call (verbose). On one card the mesh has one
shard and each epoch is one replay of its epoch graph; on several, each
card's epoch is one graph, replayed once an epoch, its shards' gradients
gathered into every card inside it (``kernels/peer_exchange.py``) and
summed there in shard order. It checks: one graph captured a card and each
replayed once an epoch, every card's replica of the state bit for bit card
0's, the mesh's nets within rtol=1e-4, atol=1e-5 of the unsharded ones and
its threshold within 1e-5, the results on card 0. Then it times the
training loop at ``TIMED_EPOCHS`` epochs in turns (plain, cards, one card,
one card, cards, plain): the mesh's per-step route (``epoch.plain``), its
graphs, and the unsharded epoch graph on card 0 (what one card does, bit
for bit the one-shard mesh); wall and steps per second. The graphs' net must
be the per-step route's bit for bit, and each route's two runs the same.
Then where a run's time goes, for the mesh's graphs and one card's: the
first call of a new epoch function (one epoch, its warm-up and captures
included) and the median of 6 calls of ``TIMED_EPOCHS`` epochs from its
cached graphs (replays only; two turns of 3, in turns); and a ``torch.profiler`` trace of
one call of 3 epochs from the cached graphs: each card's kernel time, the
exchange's push and wait kernels apart (a wait's time is mostly its spin).
Last, the train CLI at its defaults with ``--data-parallel`` and without
it, on the same file, at ``TIMED_EPOCHS`` epochs and at the CLI's 300, in
turns: rc 0, the flag's run through one graph a card, each route's two net
files byte for byte alike, and the flag's state at ``TIMED_EPOCHS`` epochs
bit for bit the per-step route's from the run's initial state and rows.
(The nets with and without the flag are not held to each other beyond a
few epochs: Adam's step is about the learning rate whatever a gradient's
size, so the rounding of a near-zero gradient's mean, which differs
between 4 shards and one batch, moves weights by that much.)
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
import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from chip_smoke import (
    TRAIN_SECONDS,
    TrainSpy,
    labeled_files,
    plain_epochs,
    run_train,
    same_bits,
)
from syllable_detector_tpu_torch.parallel import mesh as pmesh
from syllable_detector_tpu_torch.training import trainer
from syllable_detector_tpu_torch.utils.synth import make_labeled_audio

EPOCHS = 3
TIMED_EPOCHS = 30
CLI_EPOCHS = 300


def replicas_equal(epoch_fn) -> int:
    """Raise unless every card's replica of the state in each graph of the
    mesh's epoch function is card 0's, bit for bit; the replicas checked."""
    if not isinstance(epoch_fn, trainer._CardsEpoch):
        return 0
    checked = 0
    for graph in epoch_fn.graphs.values():
        for params, opt_state in zip(graph.params[1:], graph.opt_state[1:]):
            if not same_bits((params, opt_state), (graph.params[0], graph.opt_state[0])):
                raise AssertionError("a card's replica is not card 0's bit for bit")
            checked += 1
    return checked


def sync() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall_of(call) -> float:
    """Host seconds of ``call()`` to the completion of every card's work."""
    sync()
    t0 = time.perf_counter()
    call()
    sync()
    return time.perf_counter() - t0


def profile(call) -> dict:
    """Each card's kernel ms in a ``torch.profiler`` trace of the second of
    two calls of ``call()`` (the first warms the tracer):
    ``{card: {"push": ms, "wait": ms, "rest": ms}}``."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        for _ in range(2):
            call()
            sync()
            prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    cards: dict = {}
    for event in events:
        if event.get("cat") != "kernel":
            continue
        card = int(event.get("args", {}).get("device", event.get("pid")))
        kind = next((k for k in ("push", "wait") if f"{k}_kernel" in event["name"]), "rest")
        by = cards.setdefault(card, {"push": 0.0, "wait": 0.0, "rest": 0.0})
        by[kind] += event["dur"] / 1e3
    return cards


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
    replicas = replicas_equal(spy.runs[0]["first"][0])
    worst = max(float((a.cpu() - b.cpu()).abs().max())
                for a, b in zip(pmesh._leaves(sharded), pmesh._leaves(whole)))
    print(f"mesh {mesh}; {len(feats)} evaluations, {steps} steps over {EPOCHS} one-epoch calls; "
          f"graphs {graphs}; {replicas} replicas bit for bit card 0's; sharded vs unsharded "
          f"params max abs {worst:.3g}, thresholds {t_sharded:.6f} / {t_whole:.6f}", flush=True)
    want = {"captures": cards, "replays": cards * EPOCHS}
    if graphs != want or replicas != cards - 1:
        raise AssertionError(f"graphs {graphs}, {replicas} replicas checked for {cards} card(s) "
                             f"and {EPOCHS} epochs")
    for a, b in zip(pmesh._leaves(sharded), pmesh._leaves(whole)):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-5)
    if abs(t_sharded - t_whole) > 1e-5:
        raise AssertionError(f"thresholds {t_sharded} / {t_whole}")
    if {t.device for t in pmesh._leaves(sharded)} != {mesh.devices[0]}:
        raise AssertionError("the sharded net is not on shard 0's card")

    timed = trainer.TrainSettings(epochs=TIMED_EPOCHS, batch_size=256, learning_rate=3e-3)
    times, nets = {}, {}
    for name in ("plain", "cards", "one card", "one card", "cards", "plain"):
        with TrainSpy() as spy, (plain_epochs() if name == "plain" else contextlib.nullcontext()):
            if name == "one card":
                net = trainer.train(timed, feats, labels, device="cuda")[1]
            else:
                net = trainer.train(timed, feats, labels, mesh=mesh)[1]
        run = spy.runs[0]
        if name == "cards":
            replicas_equal(run["first"][0])
        nets.setdefault(name, []).append(net)
        times.setdefault(name, []).append((run["wall"], run["steps"] / run["wall"]))
    if not all(same_bits(*runs) for runs in nets.values()):
        raise AssertionError("two timed runs of one route gave other nets")
    if not same_bits(nets["cards"][0], nets["plain"][0]):
        raise AssertionError("the graphs' net is not the per-step route's bit for bit")
    print(f"training loop, {TIMED_EPOCHS} epochs ({run['steps']} steps) on {mesh}, in turns "
          f"(plain, cards, one card, one card, cards, plain): "
          + "; ".join(f"{name} " + ", ".join(f"{w:.3f} s ({r:.1f} steps/s)" for w, r in walls)
                      for name, walls in times.items())
          + "; the graphs' nets bit for bit the per-step route's", flush=True)

    epoch_fn, first = run["first"]
    spec, steps_per_epoch = trainer._build_net_spec(timed), epoch_fn.steps
    state = first[:4]
    rows = first[4][: TIMED_EPOCHS * steps_per_epoch]
    fresh = {"cards": lambda: trainer._make_restart_epoch(spec, timed.learning_rate, mesh=mesh,
                                                          steps=steps_per_epoch),
             "one card": lambda: trainer._make_restart_epoch(spec, timed.learning_rate,
                                                             steps=steps_per_epoch)}
    fns, split = {}, {}
    for name in ("cards", "one card", "one card", "cards"):
        if name not in fns:
            fns[name] = fresh[name]()
            split[name, "first"] = wall_of(lambda: fns[name](*state, rows[:steps_per_epoch]))
        split.setdefault((name, "replays"), []).extend(
            wall_of(lambda: fns[name](*state, rows)) for _ in range(3))
    kernels = profile(lambda: fns["cards"](*state, rows[: 3 * steps_per_epoch]))
    print("where the time goes: the first call (one epoch, warm-up and capture included) / "
          f"the median of 6 calls of {TIMED_EPOCHS} epochs from the cached graphs: "
          + "; ".join(f"{name} {split[name, 'first']:.3f} s / "
                      f"{statistics.median(split[name, 'replays']):.3f} s = "
                      f"{1e3 * statistics.median(split[name, 'replays']) / len(rows):.4f} ms a step"
                      for name in fresh)
          + f"; a trace of 3 epochs ({3 * steps_per_epoch} steps) of the cards' graphs, each "
          "card's kernel ms (push / wait / the rest): "
          + ", ".join(f"cuda:{card} {k['push']:.2f} / {k['wait']:.2f} / {k['rest']:.2f}"
                      for card, k in sorted(kernels.items())), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        _, _, wav, csv = labeled_files(tmp, "train", 31)
        argv = ["-a", wav, "-l", csv, "--device", "cuda", "--quiet"]
        walls, files, dp_graphs = {}, {}, {}
        for epochs in (TIMED_EPOCHS, CLI_EPOCHS):
            for turn, flag in enumerate((True, False, False, True)):
                trainer.EPOCH_GRAPHS = {"captures": 0, "replays": 0}
                name, out = "dp" if flag else "one", f"{tmp}/{turn}.txt"
                with TrainSpy() as spy:
                    walls.setdefault((epochs, name), []).append(run_train(
                        argv + ["--epochs", str(epochs), "-o", out] + ["--data-parallel"] * flag))
                with open(out, "rb") as f:
                    files.setdefault((epochs, name), set()).add(f.read())
                if flag:
                    dp_graphs[epochs], dp_run = dict(trainer.EPOCH_GRAPHS), spy.runs[0]
            if epochs == TIMED_EPOCHS:
                epoch_fn, first = dp_run["first"]
                if first[4].shape[0] != dp_run["steps"]:
                    raise AssertionError("the CLI's run took more than one epoch call")
                if not same_bits(dp_run["final"], epoch_fn.plain(*first)[:2]):
                    raise AssertionError("train --data-parallel's state is not the per-step "
                                         "route's bit for bit")
    if any(len(nets) != 1 for nets in files.values()):
        raise AssertionError("two runs of one route wrote other net files")
    if any(g["captures"] != cards for g in dp_graphs.values()):
        raise AssertionError(f"train --data-parallel took graphs {dp_graphs} on {cards} card(s)")
    print(f"train.main on the {TRAIN_SECONDS:g} s file at the CLI defaults, in turns "
          f"(--data-parallel, without, without, --data-parallel; {cards} shard(s), graphs "
          f"{dp_graphs}): "
          + "; ".join(f"{epochs} epochs " + ", ".join(
              f"{name} " + " / ".join(f"{w:.3f}" for w in walls[epochs, name]) + " s"
              for name in ("dp", "one")) for epochs in (TIMED_EPOCHS, CLI_EPOCHS))
          + f"; rc 0, each route's net files byte for byte alike, the flag's state at "
          f"{TIMED_EPOCHS} epochs bit for bit the per-step route's", flush=True)
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
