"""The port's multi-process corpus scan (``dist_scan``): the file list
sharded over two local processes on the CPU, joined with torch.distributed's
gloo backend over 127.0.0.1, against the single-process batched scan.

The merged CSV must equal the single-process ``--batched`` CSV line for line
(the same code scans the same files, only in two processes), and every rank
must report the same global detection count. A subprocess timeout turns a
hung rendezvous into a failure.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from syllable_detector_tpu.config.model_format import save_config
from syllable_detector_tpu.dist_scan import shard_paths as jax_shard_paths
from syllable_detector_tpu.utils.wav import write_wav
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.cli import main as port_main
from syllable_detector_tpu_torch.dist_scan import shard_paths
from test_torch_cli import blocked_run, run

# one thread here and in every child: a product's bits depend on how many
# threads share it, and the CSVs are compared line for line
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.mark.parametrize(
    "n_files,procs", [(7, 3), (7, 1), (0, 2), (2, 4), (8, 2), (5, 5)]
)
def test_shard_paths_partition(n_files, procs):
    paths = [f"f{i}" for i in range(n_files)]
    shards = [shard_paths(paths, i, procs) for i in range(procs)]
    # complete, disjoint, order-preserving, contiguous; none lost when there
    # are more processes than files
    assert sum(shards, []) == paths
    assert shards == [jax_shard_paths(paths, i, procs) for i in range(procs)]
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    audio = [
        np.stack([fixtures.chirp_audio(0.4, 90), fixtures.chirp_audio(0.4, 91)], 1),
        fixtures.chirp_audio(0.3, 92)[:, None],
        fixtures.chirp_audio(0.5, 93)[:, None],
    ]
    heard = np.concatenate([a.T.reshape(-1) for a in audio])
    nets = []
    for seed in (94, 95):
        nets.append(str(d / f"net{seed}.txt"))
        save_config(fixtures.pick_thresholds(fixtures.sample_geometry_config(seed), heard), nets[-1])
    paths = []
    for i, a in enumerate(audio):
        paths.append(str(d / f"c{i}.wav"))
        write_wav(paths[-1], a, 44100, dtype="float32")
    return nets, paths, d


def run_ranks(nets, paths, out_dir, procs=2, extra=()):
    port = free_port()
    common = [a for n in nets for a in ("-n", n)] + [a for p in paths for a in ("-a", p)]
    running = [
        subprocess.Popen(
            [sys.executable, "-m", "syllable_detector_tpu_torch.dist_scan",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(procs),
             "--process-id", str(rank), "--device", "cpu", "-o", str(out_dir),
             *common, *extra],
            cwd=REPO, env=ONE_THREAD, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for rank in range(procs)
    ]
    results = []
    try:
        for proc in running:
            out, err = proc.communicate(timeout=240)  # a hung rendezvous fails here
            results.append((proc.returncode, err))
    finally:
        for proc in running:
            if proc.poll() is None:
                proc.kill()
    return results


@pytest.mark.parametrize("variant", ["fused", "matmul, two nets, groups"])
def test_two_process_scan_matches_single_process(corpus, variant, tmp_path):
    nets, paths, _ = corpus
    if variant == "fused":
        nets, extra = nets[:1], ["--method", "fused", "-d", "0.02"]
    else:
        extra = ["--method", "matmul", "--batch-files", "1"]
    results = run_ranks(nets, paths, tmp_path / "out", extra=extra)
    totals = []
    for rank, (rc, err) in enumerate(results):
        assert rc == 0, err
        m = re.search(rf"process {rank}/2: (\d) files, (\d+) detections \(global (\d+)\)", err)
        assert m, err
        totals.append((int(m.group(1)), int(m.group(2)), int(m.group(3))))
    assert [t[0] for t in totals] == [1, 2]  # 3 files split 1 + 2
    assert totals[0][2] == totals[1][2] == totals[0][1] + totals[1][1] > 0
    assert "merged ->" in results[0][1] and "merged ->" not in results[1][1]

    merged = (tmp_path / "out" / "merged.csv").read_text().splitlines()
    argv = [a for n in nets for a in ("-n", n)] + [a for p in paths for a in ("-a", p)]
    rc, want, _ = run(port_main, argv + ["--batched", "--device", "cpu"] + extra)
    assert rc == 0 and merged == want
    assert sum(line in paths for line in merged) == 3
    assert len(merged) - 3 == totals[0][2]
    shards = [(tmp_path / "out" / f"shard{i}.csv").read_text() for i in range(2)]
    assert "".join(shards).splitlines() == merged


def test_single_file_keeps_headers_off_and_bad_net_fails(corpus, tmp_path):
    nets, paths, d = corpus
    # one file in all: no header line, as the CLI; the first rank is idle
    results = run_ranks(nets[:1], paths[:1], tmp_path / "one", extra=["--method", "fused"])
    assert [rc for rc, _ in results] == [0, 0]
    merged = (tmp_path / "one" / "merged.csv").read_text().splitlines()
    rc, want, _ = run(port_main, ["-n", nets[0], "-a", paths[0], "--batched", "--method",
                                  "fused", "--device", "cpu"])
    assert merged == want and paths[0] not in merged and len(merged) > 3
    assert "process 0/2: 0 files, 0 detections" in results[0][1]
    bad = d / "bad.txt"
    bad.write_text("samplingRate = 44100\n")
    results = run_ranks([str(bad)], paths, tmp_path / "bad", procs=1)
    assert results[0][0] == 1 and "Unable to load" in results[0][1]


def test_dist_scan_runs_with_jax_blocked(corpus, tmp_path):
    """The entry point and the mesh run in a process where importing jax or
    the JAX package fails."""
    nets, paths, _ = corpus
    port = free_port()
    argv = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0",
            "--device", "cpu", "-o", str(tmp_path / "solo"), "-n", nets[0],
            "-a", paths[0], "-a", paths[1], "--method", "fused"]
    script = (
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from syllable_detector_tpu_torch import dist_scan, parallel, cli\n"
        f"assert dist_scan.main({argv!r}) == 0\n"
        f"assert cli.main(['-n', {nets[0]!r}, '-a', {paths[0]!r}, '--batched', '--mesh',\n"
        "                 '--method', 'fused', '--device', 'cpu']) == 0\n"
        "mesh = parallel.make_mesh(2, devices=['cpu'])\n"
        "assert mesh.shape == {'channel': 2}\n"
    )
    proc = blocked_run(script)
    assert proc.returncode == 0, proc.stderr
    merged = (tmp_path / "solo" / "merged.csv").read_text().splitlines()
    rc, want, _ = run(port_main, ["-n", nets[0], "-a", paths[0], "-a", paths[1], "--batched",
                                  "--method", "fused", "--device", "cpu"])
    assert merged == want and "Mesh: 1 shard(s) on cpu." in proc.stderr


def test_cuda_without_card_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    nets, paths, _ = corpus
    proc = subprocess.run(
        [sys.executable, "-m", "syllable_detector_tpu_torch.dist_scan", "--coordinator",
         f"127.0.0.1:{free_port()}", "--num-processes", "1", "--process-id", "0",
         "-n", nets[0], "-a", paths[0], "-o", str(tmp_path / "o")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
