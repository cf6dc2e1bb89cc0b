"""Multi-process corpus scan on PyTorch: the file list sharded over processes.

Counterpart of ``syllable_detector_tpu.dist_scan``. Every process joins one
``torch.distributed`` group (gloo backend, rendezvous over TCP at
``--coordinator``), takes a contiguous share of the FILE LIST (files and
channels are embarrassingly parallel, so the only traffic between processes
is the rendezvous and the final count), scans its share with the batched
device path, and the detection counts are gathered across the processes
before process 0 merges the per-shard CSVs. gloo carries the int32 count
between host buffers, so several processes may share one card.

Usage (run the same command on every host, or once per process):

  python -m syllable_detector_tpu_torch.dist_scan \\
      --coordinator HOST0:9876 --num-processes N --process-id I \\
      -n NET.txt -a A.wav -a B.wav ... -o OUT_DIR [--device cpu]

Process i writes ``OUT_DIR/shard{i}.csv``; process 0 waits for every shard
(the gather is the barrier) and merges them into ``OUT_DIR/merged.csv`` in
the original file order.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

__all__ = ["shard_paths", "main"]


def shard_paths(paths, process_id: int, num_processes: int):
    """Deterministic contiguous partition of the corpus file list.

    Contiguous (not round-robin) so each shard's CSV concatenation preserves
    the CLI's file order when merged by shard index.
    """
    n = len(paths)
    lo = (n * process_id) // num_processes
    hi = (n * (process_id + 1)) // num_processes
    return list(paths)[lo:hi]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="syllable-detector-dist-scan")
    p.add_argument("--coordinator", required=True,
                   help="host:port that process 0 listens on for the rendezvous.")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("-n", "--net", action="append", required=True,
                   help="Network file; repeat to give each audio channel "
                   "its own network (cycled per channel).")
    p.add_argument("-a", "--audio", action="append", default=[],
                   help="Corpus file (repeatable); the FULL list, identical "
                   "on every process: sharding is internal.")
    p.add_argument("-o", "--out", required=True, help="Shared output dir.")
    p.add_argument("-d", "--debounce", type=float, default=None)
    p.add_argument("--method", choices=("matmul", "rfft", "fused"),
                   default="matmul")
    p.add_argument("--batch-files", type=int, default=None, metavar="N",
                   help="Scan each shard in groups of N files "
                   "(bounds memory on huge corpora).")
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default: cuda).")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    # full fp32 products, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # gloo and not NCCL: the only collective is an int32 count between host
    # buffers, and NCCL cannot put two ranks on one card
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes,
        rank=args.process_id,
    )
    try:
        return _scan(args, device, dist, torch)
    finally:
        dist.destroy_process_group()


def _scan(args, device, dist, torch) -> int:
    from syllable_detector_tpu_torch.config.model_format import ConfigError, load_config
    from syllable_detector_tpu_torch.corpus import scan_corpus_files

    try:
        cfgs = [load_config(n) for n in args.net]
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1

    mine = shard_paths(args.audio, args.process_id, args.num_processes)
    os.makedirs(args.out, exist_ok=True)
    shard_file = os.path.join(args.out, f"shard{args.process_id}.csv")

    lines: list[str] = []
    n_detections = 0
    # detection rows are "channel,sample,..."; header lines are raw paths
    # (which may themselves contain commas)
    row = re.compile(r"^\d+,\d+,")

    def emit(s: str) -> None:
        nonlocal n_detections
        lines.append(s)
        if row.match(s):
            n_detections += 1

    if mine:
        # headers on every file so the merged CSV keeps the multi-file
        # contract even when a shard holds a single file
        scan_corpus_files(
            cfgs, mine, debounce_seconds=args.debounce, emit=emit,
            method=args.method, headers=len(args.audio) > 1,
            group_files=args.batch_files, device=device,
        )
    tmp = shard_file + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    os.replace(tmp, shard_file)  # atomic: merge never sees partial shards

    # the global detection count, gathered across the processes; it doubles
    # as the barrier that puts every shard file on disk before the merge
    counts = [torch.zeros(1, dtype=torch.int32) for _ in range(args.num_processes)]
    dist.all_gather(counts, torch.tensor([n_detections], dtype=torch.int32))
    total = int(torch.cat(counts).sum())
    print(
        f"process {args.process_id}/{args.num_processes}: "
        f"{len(mine)} files, {n_detections} detections "
        f"(global {total})",
        file=sys.stderr,
    )

    if args.process_id == 0:
        merged = os.path.join(args.out, "merged.csv")
        with open(merged, "w") as out_f:
            for i in range(args.num_processes):
                with open(os.path.join(args.out, f"shard{i}.csv")) as f:
                    out_f.write(f.read())
        print(f"merged -> {merged}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
