"""Every mesh path of the port on one shard per card, against the unsharded
path on card 0.

``parallel/mesh.py`` splits its work over a ``Mesh`` of devices, a CUDA
stream a shard. This script runs each path on ``make_mesh()`` (one shard
per visible card) and on ``make_mesh(4)`` laid on cuda:0 alone (four
shards sharing one card, as ``chip_smoke.py`` phase 13 runs them on a
one-card machine). The checks, in order:

  device  — from cuda:0, K1 (``fused_offline_outputs``) and K2
            (``framed_gemm``) on a tensor of each card: cuda:0 still current
            after each call, each result within its kernel's bound of its
            plain version on that card (1e-3 / 2e-4; 1e-4 / 1e-4);
  corpus  — ``chip_smoke``'s corpus (8 two-channel 60 s files at 44.1, 48 and
            96 kHz: 16 lanes, 10 resampled) through ``cli --batched --mesh
            --method fused`` and ``corpus.scan_corpus_files(mesh=)``, with one
            net and with 4 per-lane nets: the CSV line for line the
            unsharded scan's on cuda:0 (columns 1-3 equal, outputs within
            4e-7);
  fused   — the scan's padded [16, 2^22] lanes through
            ``sharded_fused_offline_outputs``, flat and grid layouts (slabs of
            2 lanes), a shared net and per-lane nets, against the unsharded
            flat kernel (atol=1e-6); each precision tier's slabbed grid on
            each shard's lanes against it within the tier's bound
            (``fixtures.TIER_CASES``);
  offline — ``sharded_offline_outputs`` (matmul) on the lanes' first 10 s
            with per-lane nets against ``batch_offline_outputs`` (1e-4 / 1e-5);
  counts  — ``sharded_detection_counts`` on them: equal to the count of the
            unsharded outputs;
  tensor  — ``tensor_sharded_offline_outputs`` on a 60 s stream, linear (1e-3
            / 2e-4), log and dB (2e-3 / 5e-4) scaling;
  time    — ``time_sharded_offline_outputs`` on a 10-minute stream, each
            shard's halo read from the next shard's card: matmul (1e-4 /
            1e-5) and fused (1e-3 / 2e-4) against ``offline_outputs`` on the
            whole stream;
  stream  — 16 lanes x 8 ``sharded_streaming_step`` calls against
            ``streaming_scan`` (1e-4 / 1e-5);
  train   — ``train_ensemble`` of 8 labeled channels (20 s each, 3 epochs, one
            epoch a call) on a channel mesh: each shard's epoch graph
            captured once and replayed once an epoch, the nets gathered on
            cuda:0 and bit for bit the unsharded ensemble's, or else within
            rtol=1e-6, atol=1e-7 with the largest difference printed.

After every path cuda:0 must still be current, and a ``torch.profiler``
trace of one call on the one-shard-a-card mesh must show kernels on every
card of the mesh (the fused detector's own kernel where the path runs it);
the line gives each card's kernel and copy time in that trace.
Then each path is timed on both meshes: the host wall (median of REPEATS
calls, each to completion on every card), each shard's device time (CUDA
events on its stream around its part of the call: its copies in and its
kernels) and the bytes the trace shows copied (between cards: "PtoP").
Run from the root of the repository, on a machine with one card or several:

    PYTHONPATH=. python3 scripts/mesh_cards.py [CHECK ...]

(every check by default). It prints every card's name and power limit, the
meshes, each check with its largest difference and its times, and how many
cards it covered; it exits non-zero when a check fails (after running the
others) or when no card is present.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

import chip_smoke as smoke
from syllable_detector_tpu_torch import corpus, fixtures
from syllable_detector_tpu_torch.config.model_format import load_config
from syllable_detector_tpu_torch.kernels import fused_detector as fused
from syllable_detector_tpu_torch.models import detector, neural_net
from syllable_detector_tpu_torch.ops import resample
from syllable_detector_tpu_torch.parallel import mesh as pmesh
from syllable_detector_tpu_torch.training import trainer
from syllable_detector_tpu_torch.utils.synth import make_labeled_audio
from syllable_detector_tpu_torch.utils.wav import read_audio

REPEATS = 5
SHARDS_ON_ONE = 4  # the shards of the mesh laid on cuda:0 alone
STEP_SECONDS = 10  # the lanes' head the matmul, count and streaming paths take
TRAIN_CHANNELS = 8
TRAIN_SECONDS = 20.0
TRAIN_EPOCHS = 3
K1_TOL = (1e-3, 2e-4)
K2_TOL = (1e-4, 1e-4)
KERNEL = "fused_detector_kernel"  # the name of K1's kernel in a trace


def sync() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def trace_summary(events: list, kernel: str | None) -> tuple[dict, dict, dict]:
    """(launches per card index of the kernels whose name holds ``kernel``
    (None: every kernel), {copy kind: [copies, bytes]}, ms per card index of
    its kernels and copies) of the events of a ``torch.profiler`` chrome
    trace. A copy between cards names its cards in its kind: the trace
    gives it a card it ran on, one it came from and one it went to (an
    event that names no card lies in its card's row of the trace)."""
    launches = collections.Counter()
    copies: dict = {}
    busy = collections.Counter()
    for event in events:
        cat, args = event.get("cat"), event.get("args", {})
        if cat not in ("kernel", "gpu_memcpy"):
            continue
        card = int(args.get("device", args.get("inDevice", event.get("pid"))))
        busy[card] += event["dur"] / 1e3
        if cat == "gpu_memcpy":
            name = event["name"]
            if "fromDevice" in args:
                name += f" cuda:{args['fromDevice']} -> cuda:{args['toDevice']}"
            kind = copies.setdefault(name, [0, 0])
            kind[0] += 1
            kind[1] += int(args["bytes"])
        elif kernel is None or kernel in event["name"]:
            launches[card] += 1
    return dict(launches), copies, dict(busy)


def traced(call, kernel: str | None, tmp: str) -> tuple[dict, dict, dict]:
    """:func:`trace_summary` of a ``torch.profiler`` trace of ``call()``,
    the second of two calls: the tracer may drop the device's records of
    the first moments of a trace (peer copies issued as it started have gone
    missing on H100s), so the first call only warms it up."""
    sync()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        for _ in range(2):
            call()
            sync()
            prof.step()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    return trace_summary(events, kernel)


@contextlib.contextmanager
def shard_events(spans: list):
    """Within the block every shard body that ``_on_shards`` runs on a card
    appends ``(shard, device, start, end)``: CUDA events recorded on the
    shard's stream around the body."""
    plain = pmesh._on_shards

    def timed(mesh, body):
        def wrapped(i, dev):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = body(i, dev)
            end.record()
            spans.append((i, dev, start, end))
            return out

        return plain(mesh, wrapped)

    pmesh._on_shards = trainer._on_shards = timed
    try:
        yield
    finally:
        pmesh._on_shards = trainer._on_shards = plain


def times(call, mesh) -> tuple[float, dict]:
    """(host ms, median of REPEATS calls to completion on every card; each
    shard's device ms, summed over its bodies in one call) of ``call(mesh)``,
    after a call to warm up."""
    call(mesh)
    walls = []
    for _ in range(REPEATS):
        sync()
        t0 = time.perf_counter()
        call(mesh)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    spans: list = []
    with shard_events(spans):
        call(mesh)
    sync()
    device_ms = collections.defaultdict(float)
    for i, dev, start, end in spans:
        device_ms[i, dev] += start.elapsed_time(end)
    return statistics.median(walls), dict(device_ms)


class Cards:
    """The visible cards, the two meshes over them and the inputs the checks
    share (made at first use, on cuda:0)."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.home = self.cards[0]
        self.mesh = pmesh.make_mesh(devices=self.cards)
        self.shared = pmesh.make_mesh(SHARDS_ON_ONE, devices=self.cards[:1])

    @functools.cached_property
    def fixture(self) -> dict:
        """The corpus files and nets, and the scan's padded lanes with the
        nets' spec and params on the first card."""
        files, nets = smoke.corpus_fixture(self.tmp)
        pairs = [detector.detector_spec_from_config(load_config(n), self.home) for n in nets]
        streams = []
        for path in files:
            samples, rate = read_audio(path)
            if rate != smoke.NET_RATE:
                samples = corpus.resample_channels(samples, rate, smoke.NET_RATE, self.home)
            streams += [np.ascontiguousarray(samples[:, c]) for c in range(samples.shape[1])]
        xs = torch.zeros((len(streams), corpus._bucket(max(map(len, streams)))),
                         device=self.home)
        for i, s in enumerate(streams):
            xs[i, : len(s)] = torch.from_numpy(s)
        params = [p for _, p in pairs]
        return {"files": files, "nets": nets, "spec": pairs[0][0], "params": params,
                "per_lane": [params[lane % len(params)] for lane in range(len(streams))],
                "xs": xs}

    @functools.cached_property
    def long_stream(self) -> torch.Tensor:
        return torch.from_numpy(smoke.long_stream()).to(self.home)


def run_form(cards: Cards, name: str, call, check, kernel: str | None = KERNEL,
             again=None) -> None:
    """One mesh path: ``check(call(mesh))`` (its largest differences, or it
    raises) on both meshes, cuda:0 current after each; a trace of the
    one-shard-a-card call (or of ``again(its result)()``) with ``kernel``
    launched on every card of the mesh; then the times on both meshes.
    Prints one line."""
    verdicts = []
    for mesh in (cards.mesh, cards.shared):
        result = call(mesh)
        verdicts.append(f"{mesh}: {check(result)}")
        smoke.same_device(0, f"{name} on {mesh}")
        if mesh is cards.mesh:
            traced_call = again(result) if again else (lambda: call(cards.mesh))
    launches, copies, busy = traced(traced_call, kernel, cards.tmp)
    missing = sorted({d.index for d in cards.mesh.devices} - set(launches))
    if missing:
        raise AssertionError(f"{name}: no {kernel or 'kernel'} on cuda:{missing} ({launches})")
    timed = []
    for mesh in (cards.shared, cards.mesh):
        wall, device_ms = times(call, mesh)
        timed.append(
            f"{mesh}: wall {wall:.3f} ms, shards "
            + ", ".join(f"{i}@{dev} {ms:.3f}" for (i, dev), ms in sorted(device_ms.items(),
                                                                        key=lambda kv: kv[0][0]))
            + " ms device")
    smoke.same_device(0, f"{name} timed")
    print(
        f"mesh_cards {name}: {'; '.join(verdicts)}; cuda:0 current after each; launches of "
        f"{kernel or 'every kernel'} by card {dict(sorted(launches.items()))}; kernel and copy "
        f"ms by card {', '.join(f'cuda:{d} {ms:.3f}' for d, ms in sorted(busy.items()))}; copies "
        + (", ".join(f"{kind} {n} x {nbytes} B" for kind, (n, nbytes) in sorted(copies.items()))
           or "none")
        + f"; times (host median of {REPEATS}, device by CUDA events): {'; '.join(timed)} ok",
        flush=True,
    )


def check_device(cards: Cards) -> None:
    """K1 and K2 on each card, called from cuda:0."""
    cfg = fixtures.sample_geometry_config(0)
    x = fixtures.chirp_audio(60.0, 91)
    x48 = fixtures.chirp_audio(60.0, 92, rate=48000)
    moved, report, first = [], [], None
    for card in cards.cards:
        spec, params = detector.detector_spec_from_config(cfg, card)
        xd = torch.from_numpy(x).to(card)
        got = fused.fused_offline_outputs(spec, params, xd)
        after_k1 = torch.cuda.current_device()
        # each call is made from cuda:0
        torch.cuda.set_device(0)
        xin, g, w_len, overlap, frames, _ = resample.polyphase_framing(
            x48, 48000, smoke.NET_RATE, device=card)
        got2 = smoke.fg.framed_gemm(xin, g, w_len, overlap, frames)
        after_k2 = torch.cuda.current_device()
        torch.cuda.set_device(0)
        for kernel, after in (("K1", after_k1), ("K2", after_k2)):
            if after != 0:
                moved.append(f"{kernel} on {card} left cuda:{after} current")
        folded = fused.fold_constants(spec, params, card)
        k1 = smoke.held(got, fused.fused_offline_outputs_reference(spec, folded, xd),
                        *K1_TOL, f"K1 on {card}")
        k2 = smoke.held(got2, smoke.fg.framed_gemm_reference(xin, g, w_len, overlap, frames),
                        *K2_TOL, f"K2 on {card}")
        if got.device != card or got2.device != card:
            raise AssertionError(f"K1 / K2 on {card} gave results on {got.device} / {got2.device}")
        if first is None:
            first = (got, got2)
        same = smoke.same_bits((got, got2), first)
        report.append(f"{card}: current after K1 cuda:{after_k1}, after K2 cuda:{after_k2}, "
                      f"vs plain {k1:.3g} / {k2:.3g}, "
                      f"{'bit for bit' if same else 'not bit for bit'} cuda:0's")
    print(f"mesh_cards device: from cuda:0, {'; '.join(report)}", flush=True)
    if moved:
        raise AssertionError("; ".join(moved))
    print("mesh_cards device: cuda:0 current after every K1 and K2 call ok", flush=True)


def scan(files: list, cfgs: list, mesh, device) -> list[str]:
    """The CSV lines of ``scan_corpus_files`` over ``files`` with the fused
    method, on ``mesh``, the lanes placed on ``device``."""
    lines: list[str] = []
    corpus.scan_corpus_files(cfgs, files, emit=lines.append, err=lambda s: None,
                             method="fused", mesh=mesh, device=device)
    return lines


def check_corpus(cards: Cards) -> None:
    c = cards.fixture
    audio = [a for f in c["files"] for a in ("-a", f)] + ["--device", str(cards.home)]
    for nets in (c["nets"][:1], c["nets"]):
        argv = [a for n in nets for a in ("-n", n)] + audio + ["--batched", "--method", "fused"]
        want = smoke.run_cli(argv)[0]
        if len(want) < len(c["files"]) + 100:
            raise AssertionError(f"the unsharded scan gave {len(want)} lines")
        got, wall, err = smoke.run_cli(argv + ["--mesh"])
        if f"Mesh: {cards.mesh}." not in err:
            raise AssertionError(f"cli --mesh did not shard over {cards.mesh}: {err[-500:]}")
        worst = smoke.same_csv(got, want, f"cli --mesh, {len(nets)} net(s)")
        smoke.same_device(0, "cli --mesh")
        print(f"mesh_cards corpus: cli --batched --mesh --method fused, {len(nets)} net(s), on "
              f"{cards.mesh} ({wall:.2f} s): {len(got)} lines equal to the unsharded scan's, "
              f"outputs max diff {worst:.3g} ok", flush=True)
        cfgs = [load_config(n) for n in nets]
        run_form(cards, f"scan_corpus_files, {len(nets)} net(s)",
                 lambda mesh, cfgs=cfgs: scan(c["files"], cfgs, mesh, cards.home),
                 lambda lines, want=want: f"{smoke.same_csv(lines, want, 'scan'):.3g}")


def tiered(mesh, spec, params, xs: torch.Tensor, kw: dict) -> torch.Tensor:
    """Each shard's lanes through the slabbed grid under a precision tier
    (``kw``), joined on shard 0's card as the mesh's forms join theirs (the
    sharded entry takes no tier, as the JAX package's does not)."""
    local = pmesh._local(mesh, xs.shape[0])

    def body(i, dev):
        mine = list(params[local(i)]) if isinstance(params, list) else params
        return fused.fused_batch_offline_outputs(spec, mine, xs[local(i)].to(dev),
                                                 slab_channels=2, **kw)

    return pmesh._gather(mesh, pmesh._on_shards(mesh, body))


def check_fused(cards: Cards) -> None:
    c = cards.fixture
    spec, xs = c["spec"], c["xs"]
    for what, nets in (("a shared net", c["params"][0]), ("per-lane nets", c["per_lane"])):
        flat = fused.fused_batch_offline_outputs(spec, nets, xs)
        for layout in ("flat", "grid"):
            run_form(
                cards, f"sharded_fused_offline_outputs({layout}), {what}",
                lambda mesh, nets=nets, layout=layout: pmesh.sharded_fused_offline_outputs(
                    mesh, spec, nets, xs, layout=layout, slab_channels=2),
                lambda got, flat=flat: f"{smoke.held(got, flat, 0.0, 1e-6, 'sharded'):.3g}")
        for tier, kw in smoke.TIER_KW.items():
            run_form(
                cards, f"the {tier} tier's slabbed grid a shard, {what}",
                lambda mesh, nets=nets, kw=kw: tiered(mesh, spec, nets, xs, kw),
                lambda got, flat=flat, tier=tier: f"{smoke.held(got, flat, *smoke.TIER_TOL[tier], tier):.3g}")


def head(cards: Cards) -> tuple:
    """(spec, the first net, per-lane nets stacked, the lanes' first
    STEP_SECONDS)."""
    c = cards.fixture
    xs = c["xs"][:, : STEP_SECONDS * smoke.NET_RATE].contiguous()
    return c["spec"], c["params"][0], neural_net.stack_params(c["per_lane"]), xs


def check_offline(cards: Cards) -> None:
    spec, _, stacked, xs = head(cards)
    want = pmesh.batch_offline_outputs(spec, stacked, xs)
    run_form(cards, "sharded_offline_outputs (matmul), per-lane nets",
             lambda mesh: pmesh.sharded_offline_outputs(mesh, spec, stacked, xs),
             lambda got: f"{smoke.held(got, want, 1e-4, 1e-5, 'sharded_offline_outputs'):.3g}",
             kernel=None)


def check_counts(cards: Cards) -> None:
    spec, params, _, xs = head(cards)
    # the first net on every lane: its threshold lies away from every output
    shared = neural_net.stack_params([params] * xs.shape[0])
    outs = pmesh.batch_offline_outputs(spec, shared, xs)
    want = int((outs >= torch.tensor(spec.thresholds, device=cards.home)).sum())

    def check(counts):
        if (counts.device != cards.home or counts.dtype != torch.int32
                or int(counts[0]) != want or want <= 0):
            raise AssertionError(f"sharded_detection_counts {counts} against {want}")
        return f"{counts.tolist()} equal"

    run_form(cards, "sharded_detection_counts",
             lambda mesh: pmesh.sharded_detection_counts(mesh, spec, shared, xs), check,
             kernel=None)


def check_tensor(cards: Cards) -> None:
    x = cards.long_stream[: int(smoke.CORPUS_SECONDS * smoke.NET_RATE)]
    for scaling, tol in (("linear", (1e-3, 2e-4)), ("log", (2e-3, 5e-4)), ("db", (2e-3, 5e-4))):
        spec, params = detector.detector_spec_from_config(
            fixtures.sample_geometry_config(0, scaling=scaling), cards.home)
        want = detector.offline_outputs(spec, params, x)
        run_form(cards, f"tensor_sharded_offline_outputs ({scaling})",
                 lambda mesh, spec=spec, params=params: pmesh.tensor_sharded_offline_outputs(
                     mesh, spec, params, x),
                 lambda got, want=want, tol=tol: f"{smoke.held(got, want, *tol, 'tensor'):.3g}",
                 kernel=None)


def check_time(cards: Cards) -> None:
    c = cards.fixture
    spec, params, x = c["spec"], c["params"][0], cards.long_stream
    whole = detector.offline_outputs(spec, params, x)
    for method, tol in (("matmul", (1e-4, 1e-5)), ("fused", K1_TOL)):
        run_form(cards, f"time_sharded_offline_outputs ({method}, {len(x)} samples)",
                 lambda mesh, method=method: pmesh.time_sharded_offline_outputs(
                     mesh, spec, params, x, method=method),
                 lambda got, tol=tol: f"{smoke.held(got, whole, *tol, 'time-sharded'):.3g}",
                 kernel=KERNEL if method == "fused" else None)


def check_stream(cards: Cards) -> None:
    spec, _, stacked, xs = head(cards)
    plist = cards.fixture["per_lane"]
    hops, steps, r = 16, 8, spec.residual
    carries = neural_net.stack_params([detector.streaming_init(spec, lane[:r]) for lane in xs])
    used = r + steps * hops * spec.hop
    want = torch.stack([detector.streaming_scan(spec, plist[lane], xs[lane, :used])
                        for lane in range(len(xs))])

    def call(mesh):
        state, rows = carries, []
        for step in range(steps):
            lo = r + step * hops * spec.hop
            state, out = pmesh.sharded_streaming_step(
                mesh, spec, stacked, state, xs[:, lo : lo + hops * spec.hop].contiguous())
            rows.append(out)
        return torch.cat(rows, dim=1)[:, spec.history :]

    run_form(cards, f"sharded_streaming_step ({len(xs)} lanes x {steps} steps of {hops} hops)",
             call,
             lambda got: f"{smoke.held(got, want[:, : got.shape[1]], 1e-4, 1e-5, 'stream'):.3g}",
             kernel=None)


def check_train(cards: Cards) -> None:
    settings = trainer.TrainSettings(epochs=TRAIN_EPOCHS, batch_size=256, learning_rate=3e-3)
    data = [trainer.features_and_labels(settings, *make_labeled_audio(TRAIN_SECONDS, seed=100 + c),
                                        device=cards.home) for c in range(TRAIN_CHANNELS)]
    feats, labels = [f for f, _ in data], [lab for _, lab in data]
    whole = trainer.train_ensemble(settings, feats, labels, device=cards.home)[1]

    def call(mesh):
        trainer.EPOCH_GRAPHS = {"captures": 0, "replays": 0}
        with contextlib.redirect_stdout(io.StringIO()), smoke.TrainSpy() as spy:
            nets = trainer.train_ensemble(settings, feats, labels, mesh=mesh, verbose=True)[1]
        return nets, dict(trainer.EPOCH_GRAPHS), len(mesh.devices), spy.runs[0]["first"]

    def check(result):
        nets, graphs, shards, _ = result
        if graphs != {"captures": shards, "replays": TRAIN_EPOCHS * shards}:
            raise AssertionError(f"epoch graphs {graphs} for {shards} shards, "
                                 f"{TRAIN_EPOCHS} one-epoch calls")
        if {t.device for net in nets for t in pmesh._leaves(net)} != {cards.home}:
            raise AssertionError("the sharded nets are not gathered on cuda:0")
        verdict = smoke.graph_against_plain(nets, whole, "the channel mesh's nets")
        return f"epoch graphs {graphs}, nets {verdict} the unsharded ensemble's"

    # the trace: the run's first epoch call again, its graphs replayed (a
    # capture is not traced)
    run_form(cards, f"train_ensemble ({TRAIN_CHANNELS} channels, {TRAIN_EPOCHS} epochs)",
             call, check, kernel=None,
             again=lambda result: lambda: result[3][0](*result[3][1]))


CHECKS = {
    "device": check_device, "corpus": check_corpus, "fused": check_fused,
    "offline": check_offline, "counts": check_counts, "tensor": check_tensor,
    "time": check_time, "stream": check_stream, "train": check_train,
}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("mesh_cards: no CUDA device is available", file=sys.stderr)
        return 1
    unknown = [name for name in argv if name not in CHECKS]
    if unknown:
        print(f"mesh_cards: unknown checks {unknown}; choose from {list(CHECKS)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    torch.cuda.set_device(0)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        cards = Cards(tmp)
        print(f"mesh_cards: torch {torch.__version__}, CUDA {torch.version.cuda}; meshes "
              f"{cards.mesh} and {cards.shared}", flush=True)
        for name in argv or CHECKS:
            try:
                CHECKS[name](cards)
            except Exception:
                traceback.print_exc()
                failed.append(name)
                # the next check starts from cuda:0 again
                torch.cuda.set_device(0)
    n = len(cards.cards)
    print(f"mesh_cards: covered {n} card{'s' if n > 1 else ''} "
          f"({', '.join(map(str, cards.cards))}); "
          + (f"FAILED: {', '.join(failed)}" if failed else "every check passed"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
