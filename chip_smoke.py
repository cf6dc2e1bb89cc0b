"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

  1. device  — require a CUDA card; print its name and power limit.
  2. build   — build every kernel from csrc/ with nvcc, one nvcc per
               source (the fused detector's one per layout), all started
               together; ptxas' registers and spill bytes of every kernel
               (the fused detector's instantiations named by wire,
               arithmetic, input form and layout): any spill fails, and so
               does an instantiation above the registers its layout has in
               ``fused.KERNEL_REGISTERS`` (the figure ``cta_choice`` counts
               CTAs an SM by), or a resident fp32 one from samples on the
               CUDA cores outside 104-120; a framed GEMM slot-form
               instantiation above ``fg.SLOT_REGISTERS`` for its frames a
               lane (the figure ``slot_tiling`` counts CTAs an SM by).
  3. kernel  — the kernel against its plain PyTorch version and the
               unfused path, on the card, for every configuration of
               fixtures.fused_cases (10 s streams, a short one, log and dB
               scaling, a gap geometry, a 3-layer net).
  4. main    — the port's CLI (``cli.main``) on a 2-channel chirp WAV with
               a fixture net, with --method fused and --method matmul: the
               CSVs must agree, the fused run must launch the kernel, and
               the tensors must live on the card.
  5. times   — device (CUDA-event) and host medians of the kernel and its
               plain version on a 60 s stream and on one CLI drain step,
               and host-clock times of a CLI run of the 60 s file per
               method.
  6. batch   — the batched kernel (one launch per drain round, wire
               dequantised inside) against its plain version for the
               float32, int16 and mu-law wires with shared and per-lane
               nets: 256 lanes x bucket 128, 256 lanes x bucket 8, and 3
               ragged lanes whose zero tails give NaN.
  7. live    — the live batched path at full width: a 256-lane
               DetectorBank (one seeded net per lane, int16 wire,
               2048-sample chunks over 10 s, one gap) fused against
               matmul; the port's monitor with 256 channels batched
               (int16 wire, pinned ladder 128) fused against matmul; 8
               channels per lane (fused) against batched (float32 wire);
               8 channels on the mu-law wire fused against matmul. Event
               logs must be equal and no drain may fail.
  8. times   — device time of one 256 x 128 round per wire, kernel
               against plain; host time per bank.drain() round split into
               staging, copy and launch; audio seconds per wall second of
               the 256-lane monitor run.
  9. resample kernel — the framed GEMM kernel against its plain version on
               60 s inputs: the resampler's framing for 48k->44.1k,
               44.1k->48k, 96k->44.1k, 32k->44.1k and 22.05k->44.1k (hop 1),
               and the six framings of the JAX package's framed GEMM tests
               with a zero-padded tail and a dense random G; the
               resampler's framing of one 60 s channel at 192k->11.025k
               (the long launch's slot form); and of one 5 s channel at
               48k->11.025k and 96k->44.1k (the band launch); each line
               gives the launch taken (the band launch, or the long
               launch's slot or run form, each at least once), the rows of
               G a column tile or quad sums over and the kernel's device
               time. Every case again with a NaN, an Inf and a -Inf in the
               samples: NaN and Inf in the same places as in the plain
               version.
  10. corpus — the batched corpus scan, this slice's main path: 8 seeded
               2-channel 60 s chirp files at 44.1, 48 and 96 kHz (16 lanes,
               10 of them resampled on the card) through
               ``cli --batched --method fused``, against ``--batched
               --method matmul``, against the sequential ``cli --method
               fused`` per channel group, ``--batch-files 3`` against
               ungrouped, per-lane nets (4 ``-n``) fused against matmul, and
               ``sim --method fused`` against matmul. The resampler must
               have carried every resampled channel, and the batched kernel
               launched.
  11. times  — device and host ms of the framed GEMM kernel per 60 s
               channel at 48k->44.1k and 96k->44.1k beside its plain
               version and the one PyTorch call for the same product
               (``unfold`` and a matmul); host wall of the batched against
               the sequential CLI on the corpus, and of the batched scan's
               steps (read, resample, scan, CSV); the batched kernel on the
               scan's padded [16, 2^22] lanes against its plain version
               (every evaluation, rtol=1e-4, atol=1e-5, NaN in the same
               places), and both their device times.
  12. tiers, frames, slabs — on every configuration of fixtures.fused_cases:
               each precision tier (fast, split, conv, split4) on one
               stream with a shared net and on 3 lanes with per-lane nets,
               against its plain version (rtol=2e-3, atol=5e-4 for split
               and conv; 1e-2, 1e-2 for split4 and fast) and against the
               fp32 kernel; the frames input, in full fp32 and under each
               tier, against its plain version and against raw input under
               the same tier, bit for bit (one kernel and one DFT
               arithmetic read the same values from either); the grid layout
               with 160 lanes in slabs of 64 (3 slabs, the last shorter),
               shared and per-lane nets, against the flat kernel (1e-6) and
               its plain version.
  13. mesh   — this slice's main path, every count from 0: phase 10's
               corpus through ``cli --batched --mesh --method fused`` (one
               shard per card) and through ``corpus.scan_corpus_files`` on a
               4-shard mesh (4 lanes per shard, round-robin over the cards:
               all on the one card of a one-card machine), both
               CSVs equal to phase 10's line for line (outputs within
               4e-7); the scan's [16, 2^22] lanes with per-lane nets through
               ``sharded_fused_offline_outputs(layout="grid")`` and, under
               each tier, through the slabbed grid; a 10-minute mono stream
               time-sharded over 4 shards (matmul and fused) against
               ``offline_outputs`` on the whole stream and against the
               frames-input kernel on it (rtol=1e-4, atol=1e-5, as in phase
               12); the feature axis sharded over 4
               shards for linear, log and dB scaling; the sharded detection
               counts against a count of the unsharded outputs; 16 lanes x 8
               sharded streaming steps against ``streaming_scan``. Every
               result must live on the card, the mesh must span every
               visible card, and the card current before the phase must be
               current after every form. (Every form on one shard per card,
               with times: scripts/mesh_cards.py.)
  14. dist_scan — two processes of ``python -m
               syllable_detector_tpu_torch.dist_scan`` on the card (gloo over
               127.0.0.1), phase 10's 8 files split 4 + 4: ``merged.csv``
               equal to the single-process CSV, both ranks reporting the same
               global count; a rank that fails or outlasts its timeout fails
               the phase, and every process is stopped.
  15. times  — device ms of each tier and of the frames input on the 60 s
               stream beside their plain versions, the fp32 kernel and
               their times before the redesign of the tier kernel (the
               frames input also as its gather and its kernel apart); of the grid layout and each tier on the
               scan's [16, 2^22] lanes beside the flat kernel, with each
               tier's bound and earlier time there; the kernel's clock64()
               stage shares in fp32 on the 60 s stream, a 256 x 128 round
               and the scan's lanes, and under the split tier on the 60 s
               stream and the scan's lanes; host wall of the
               4-shard mesh scan
               beside the unsharded scan, in turns, of the time-sharded
               fused path beside the whole stream, and of the two-process
               scan.
  16. train  — this slice's main path, every count from 0: ``train.main``
               at the CLI defaults (300 epochs, batch 256, lr 3e-3, 4
               inits) on a 60 s labeled file (``make_labeled_audio``) with
               ``--device cuda``: rc 0, features, params and Adam state on
               the card before and after the epochs (a spy on the epoch
               loop), the epoch graph taken (``trainer.EPOCH_GRAPHS``: a
               capture, one replay per epoch trained), every net's Adam
               count equal to the optimizer steps the spy counted, the
               run's initial state not advanced, the net file loading back
               to the exported config;
               the trained net through ``cli --method fused`` (K1a must
               launch) against ``--method matmul``, CSVs equal, more than
               80 % of the detections within 0.1 s of a labeled interval;
               ``features_and_labels`` on the card against the CPU
               (rtol=1e-5, atol=1e-6, labels equal) and one epoch of
               ``_make_restart_epoch`` from the same inits (rtol=1e-4,
               atol=1e-5); a 16-channel ensemble through ``train.main`` (50
               epochs; its graph taken and counts checked as above) whose
               16 nets go through ``cli --batched --method fused`` (K1e must
               launch) against matmul on a 16-channel file; ``train`` on a
               4-shard data mesh of the one card (its epoch graph taken and
               counts checked as above) and ``train_ensemble`` on a 4-shard
               channel mesh against unsharded (2 epochs, rtol=1e-4,
               atol=1e-5), ``train`` on a one-shard data mesh bit for bit
               unsharded (params and threshold), the 4-shard data mesh's
               epoch from the CLI run's initial state over 3 epochs (one
               capture, 3 replays) bit for bit its plain per-step loop,
               every result on the card; the ``phase 16 train graph`` line: from the
               initial states of the CLI run and of the ensemble, 3 epochs
               of the epoch graph against the plain per-step loop
               (``epoch.plain``) on the card, and shard 0 of the ensemble
               on a 4-shard channel mesh (a graph a shard) against the
               plain loop on its channels: params, Adam moments and count,
               losses bit for bit, or else within rtol=1e-6, atol=1e-7 with
               the largest difference printed; a second graph call bit for
               bit the first; each graph's pool in MiB; a run interrupted
               after 1 epoch and resumed to 2 against 2 uninterrupted,
               through the CLI (net files byte for byte) and on the data
               mesh (bit for bit).
  17. times  — the plain per-step loop against the epoch graph on phase
               16's epoch: device (CUDA events) ms a step, the host enqueue
               of a plain step and of an epoch call, one epoch's wall and
               steps per second, the device's busy share over 3 epochs
               (``torch.profiler``, CUDA activity), and ``train.main`` at
               the CLI defaults cut to 30 epochs a route, in turns; the
               same with ``--data-parallel`` (one shard a card), plain,
               graph, graph, plain, each net file byte for byte that of the
               same route without the flag on one card; then the walls and
               steps per second of phase 16's main-path runs (the CLI's 300
               epochs, the ensemble's).
  18. capture — this slice's capture path, every count from 0: ``monitor
               --list-devices`` rc 0; 256 channels through ``--input alsa
               --output alsa`` and ``--input pulse --output pulse`` over fake
               sound libraries (``fixtures.ReplayAlsa`` / ``ReplayPulse``,
               injected as the modules' library handles) replaying 6 s of
               phase 7's audio on every channel, batched, int16 wire, ladder
               128: event logs equal to ``--input sim`` on the same samples
               (columns 1-3; outputs within rtol=1e-3, atol=2e-4), the same
               detections per channel, a TTL pulse on every channel that
               detected and on no other, no capture sample lost (the
               table's ``lost`` column), K1f launched; a scripted
               ``--interactive`` session on the card (8 rows, batched int16)
               against ``monitor.main``'s event log.
  19. resilient — ``ResilientDetector`` on the card: 16 lanes x 60 s with
               per-lane nets in 0.5 s chunks, two ``crash_for_test()`` calls
               mid-stream; outputs against an in-process fused DetectorBank
               fed the same chunks within 1e-6, sample indices equal; the
               child holds the card (its device files, and nvidia-smi's
               compute processes where it lists this container's); each
               child's own K1e launches (``kernel_launches()``), together
               equal to the in-process bank's; start, first-drain and
               recovery times.
  20. shard bank — ``ShardedDetectorBank`` on the card, 256 lanes, int16
               wire, per-lane nets, 2 and 4 workers: 10 rounds bit for bit
               the single-process bank's, K1f counted around the sharded
               bank's drains alone (one launch a worker a round), no worker
               holding the card, K1f at a shard's shape (each worker's last
               round from its arena, its shard's nets) against its plain
               version and timed, a round worker 0 fails followed by an
               aligned one; a round's upload from a registered arena beside a
               copy into pinned staging and a pageable upload; host ms per
               ``drain()`` round and audio s per wall s at 256 and 512 lanes
               for one process and 2 and 4 workers.
  21. tune   — ``python -m syllable_detector_tpu_torch tune --workload all``
               on a fixture net at the sample geometry (64 lanes x 2048
               evaluations; one stream of 32768), the cache it wrote (3
               entries, each candidate's device ms beside the analytic
               choice); K1a on a 60 s stream and K1e on 64 x 2048 (shared
               and per-lane nets) under the cached choice and under the
               other candidate, each against its plain version.
  22. geometry sweep — counts from 0: every K1 entry (K1a raw, K1b
               frames, K1c under each tier, K1d one slab, K1e shared and
               per-lane nets on 4 lanes, K1f int16 and mu-law) on 2 s of
               seeded audio (a stretch of silence gives NaN) at each of the
               JAX fuzz generator's seeds 1000-1099 and
               ``fixtures.wide_geometry_configs()``, against its plain
               version (phase 3's, 6's and 12's bounds, NaN in the same
               places) and bit for bit against the same launch in each
               other shared-memory layout that fits (resident, span,
               streamed, or another chunk group); K1f's every streamed
               launch (int16 and mu-law) bit for bit against the same
               launch on the float32 wire fed the samples the wire
               dequantises to; K2 on every ordered pair of
               ``fixtures.RESAMPLE_RATES`` at the resampler's ratio and the
               exact one (1e-4/1e-4); the CLI (one file, and
               ``--batched``) fused against matmul on two wide nets. One
               line counts the geometries per layout with each entry's
               worst error; one line per wide
               geometry gives each entry's device time on a 60 s stream or
               256 lanes x 128 evaluations beside its plain version, its
               bound, the layout it took and its stage shares; at three
               of them one line with K1a's and K1e's time and stage shares
               in each layout that fits (``scripts/k1_stage_shares.py``);
               one K2's at the exact 192k -> 11.025k; one line with K2 on a
               5 s channel at ten rate pairs (kernel, plain, ``unfold @ g``,
               bound, the launch taken); one line with K2 on a 60 s channel
               at the six long-hop pairs (LONG_PAIRS: the slot form) with
               the same numbers and the bound's share, each held against
               its plain version (1e-4/1e-4, and with a NaN, an Inf and a
               -Inf: NaN and Inf in the same places) and, without a row
               split, bit for bit against the run form. Then one line of
               each phase's host wall.

The line before the last is a JSON summary of the kernels (each with its
bound: the larger of its bytes over 3.35 TB/s and its operations over the
peak rate of their type, float32 at 67 TFLOP/s and, for the tiers' bf16
products, 989 TFLOP/s, the H100 SXM's published peaks; the fp32 kernel's
band DFT counts as the float32 work it replaces, whatever unit runs it;
its launches and worst error include phase 22's); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from syllable_detector_tpu_torch import cli, corpus, fixtures, monitor, sim
from syllable_detector_tpu_torch import train as train_cli
from syllable_detector_tpu_torch.config.model_format import dumps_config, load_config, save_config
from syllable_detector_tpu_torch.kernels import _build
from syllable_detector_tpu_torch.kernels import fused_detector as fused
from syllable_detector_tpu_torch.models import detector
from syllable_detector_tpu_torch.models import neural_net
from syllable_detector_tpu_torch.models.detector_bank import (
    DetectorBank,
    _mulaw_lut,
    mulaw_expand_np,
)
from syllable_detector_tpu_torch.ops import processing, resample
from syllable_detector_tpu_torch.parallel import mesh as pmesh
from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length, num_frames
from syllable_detector_tpu_torch.training import trainer
from syllable_detector_tpu_torch.utils.measure import event_ms
from syllable_detector_tpu_torch.utils.synth import make_labeled_audio
from syllable_detector_tpu_torch.utils.wav import read_audio, write_wav

# the stage shares of each layout (a script beside this one, which also runs
# on an older checkout of the port)
stage_shares_script = importlib.import_module("scripts.k1_stage_shares")

# the kernels package exports the function framed_gemm under its module's
# name, as the JAX package does, so the module comes from the import system
fg = importlib.import_module("syllable_detector_tpu_torch.kernels.framed_gemm")

KERNEL_SOURCE = "syllable_detector_tpu_torch/csrc/fused_detector.cu"
FRAMED_SOURCE = "syllable_detector_tpu_torch/csrc/framed_gemm.cu"
REPLACES = "syllable_detector_tpu/kernels/fused_detector.py:671"
REPLACES_FLAT = "syllable_detector_tpu/kernels/fused_detector.py:1704"
REPLACES_PROGRAM = "syllable_detector_tpu/kernels/fused_detector.py:1615"
REPLACES_FRAMED = "syllable_detector_tpu/kernels/framed_gemm.py:56"
REPLACES_FRAMES = "syllable_detector_tpu/kernels/fused_detector.py:1169"
REPLACES_TIERS = "syllable_detector_tpu/kernels/fused_detector.py:1193"
REPLACES_SLABBED = "syllable_detector_tpu/kernels/fused_detector.py:1378"
# the fused entries' keywords of each precision tier, and the tolerance of a
# tier's kernel against its plain version
TIER_KW = {tier: case[0] for tier, case in fixtures.TIER_CASES.items()}
TIER_TOL = {tier: case[1:] for tier, case in fixtures.TIER_CASES.items()}
MESH_SHARDS = 4
LONG_SECONDS = 600.0  # the time-sharded stream
LANES = 256  # the live-scale harness's lane count (scripts/live_scale_hw.py)
CHUNK = 2048  # its capture chunk
WIRES = ("float32", "int16", "mulaw8")
# The time-sharded fused path against the frames-input kernel on the whole
# 10-minute stream: both compute the fp32 algebra, the shards on their own
# spans. rtol=1e-4, atol=1e-5 is the unfused path's own bound against the
# JAX CLI, ten times under the kernels' bound against their plain versions.
CROSS_KERNEL_TOL = (1e-4, 1e-5)
# The tier and frames-input times before the tier kernel's redesign on the
# fp32 kernel's structure (a separate source that built each CTA's frame
# tile in shared memory; NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel
# table), printed beside this run's: the 60 s stream and the scan's
# [16, 2^22] lanes.
EARLIER_MS = {
    "fast": (0.0699, 1.704), "split": (0.1014, 2.531), "conv": (0.0916, 2.251),
    "split4": (0.1016, 2.529), "frames": (0.1315, None),
}
# the corpus: 8 two-channel files of 60 s, their rates cycling
CORPUS_FILES = 8
CORPUS_SECONDS = 60.0
CORPUS_RATES = (44100, 48000, 96000)
NET_RATE = fixtures.RATE
# published peaks of one H100 SXM (dense, no sparsity, at its 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the training slice: one labeled 60 s file per channel (make_labeled_audio,
# about 20 k evaluations), the train CLI's defaults (300 epochs, batch 256,
# lr 3e-3, 4 inits) for one net, a 16-channel ensemble of fewer epochs, and
# a few epochs for the sharded and resumed runs
TRAIN_SECONDS = 60.0
ENSEMBLE_CHANNELS = 16
ENSEMBLE_EPOCHS = 50
SHORT_EPOCHS = 2
# the epoch graph against the plain per-step loop: epochs from one state,
# and the tolerance of the comparison should the two not agree bit for bit
GRAPH_EPOCHS = 3
GRAPH_TOL = (1e-6, 1e-7)
# train.main at the CLI defaults cut to this many epochs, once a route in
# turns (phase 17's side-by-side walls)
TRAIN_AB_EPOCHS = 30
# the capture slice: phase 7's audio captured for 6 s (under the 10 s rings,
# so nothing overflows) in reads of 2205 frames, which divide 6 s at 44.1 kHz
# (the PulseAudio simple API reads whole buffers)
CAPTURE_SECONDS = 6.0
CAPTURE_FRAMES = 2205
# the crash-isolated detector: 16 lanes of 60 s in chunks of 0.5 s
RESILIENT_LANES = 16
RESILIENT_SECONDS = 60.0
RESILIENT_CHUNK = 22050
# the sharded bank: workers, lane counts, and rounds of 128 hops a lane
SHARD_WORKERS = (2, 4)
SHARD_LANES = (LANES, 2 * LANES)
SHARD_WARM = 2
SHARD_ROUNDS = 10
# rounds whose drain waits until the workers have taken in the appends
SHARD_PAUSED = 4
SHARD_PAUSE = 0.3
# the tuner's batched workloads: lanes x evaluations per lane
TUNE_LANES = 64
TUNE_EVALS = 2048
# the geometry sweep: fuzz seeds (the JAX fuzz generator's), seconds of
# audio a geometry, lanes of the batched entries, and (samples, batch) of
# each timing
GEOMETRY_SEEDS = range(1000, 1100)
GEOMETRY_SECONDS = 2.0
# K2 on short channels: one channel of SHORT_SECONDS, at the six rate pairs
# where the long launch lost most to unfold @ g and at the four into the
# sample net's rate
SHORT_SECONDS = 5.0
# K2 on long channels: one 60 s channel at the six rate pairs where the long
# launch's run form lost most to unfold @ g (the slot form's pairs)
LONG_PAIRS = ((192000, 11025), (192000, 22050), (176400, 16000), (192000, 44100),
              (96000, 22050), (176400, 32000))
SHORT_PAIRS = ((48000, 11025), (192000, 11025), (44100, 8000), (22050, 8000), (96000, 11025),
               (96000, 22050), (48000, 44100), (96000, 44100), (192000, 44100), (8000, 44100))
GEOMETRY_LANES = 4
GEOMETRY_TIMES = (3, 5)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate of their type (float32 outside the tensor
    cores, bf16 on them) and the bytes over the memory rate."""
    ops_ms = (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fused_bound(spec, lanes: int, n: int, itemsize: int, nets: int,
                tier: str | None = None, frames_input: bool = False) -> tuple[float, str]:
    """The bound of one fused detector call on ``[lanes, n]`` samples of
    ``itemsize`` bytes with ``nets`` distinct nets. Operations per frame:
    the band DFT (re and im, 2 * window * 2 * bins), |X| and the sliding
    squared sum; per evaluation, every layer's product (the first over
    timeRange frames). Under a precision tier the band DFT and the first
    layer count as the bf16 products the tier issues (1, 3 or 4 passes of
    the same multiply-adds, without the padding to the tensor cores'
    fragment) over the card's dense bf16 rate. Bytes: the samples (with
    ``frames_input`` the [F, window] frames matrix the kernel reads) and
    the outputs once, each net's DFT matrix and weights once. Transfer
    functions are not counted."""
    frames = num_frames(n, spec.window_length, spec.window_overlap)
    evals = max(0, frames - spec.time_range + 1)
    b = spec.n_bins
    sizes = spec.net.layer_sizes
    dft_passes, conv_passes = fused.TIERS[tier] if tier else (0, 0)
    dft = frames * 4 * spec.window_length * b
    first = evals * 2 * sizes[0][0] * sizes[0][1]
    rest = frames * 5 * b + evals * sum(2 * i * o for i, o in sizes[1:])
    flops = lanes * (rest + (0 if dft_passes else dft) + (0 if conv_passes else first))
    bf16_flops = lanes * (dft_passes * dft + conv_passes * first)
    operands = 2 * spec.window_length * b + sum(i * o + o for i, o in sizes)
    read = frames * spec.window_length if frames_input else n
    nbytes = lanes * (read * itemsize + evals * spec.net.outputs * 4) + nets * operands * 4
    return bound(flops, nbytes, bf16_flops)


def framed_bound(x: torch.Tensor, g: torch.Tensor, n_frames: int) -> tuple[float, str]:
    """The bound of one framed GEMM: the samples, G and the output once;
    two operations for each non-zero of G in each frame (the resampler's G
    is ~12 % non-zero)."""
    nnz = int(torch.count_nonzero(g))
    nbytes = 4 * (x.numel() + g.numel() + n_frames * g.shape[1])
    return bound(2.0 * n_frames * nnz, nbytes)


def tile_of(spec, lanes: int, n: int, tier: str | None = None,
            frames_input: bool = False) -> str:
    """The kernel's tile for a launch on ``[lanes, n]`` samples under
    ``tier``, as its wrapper chooses it: frames a CTA transforms,
    evaluations it serves, CTAs, shared memory."""
    evals = num_frames(n, spec.window_length, spec.window_overlap) - spec.time_range + 1
    width = max(w for _, w in spec.net.layer_sizes)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    frames = fused.cta_frames(spec, evals, lanes, width, sms, tier, frames_input)
    tile = frames - spec.time_range + 1
    return (f"{frames} frames a CTA for {tile} evals, {lanes * -(-evals // tile)} CTAs, "
            f"{fused.smem_bytes(spec, frames, width, tier, frames_input)} B shared")


def tiling_of(x: torch.Tensor, g: torch.Tensor, window: int, overlap: int, n_frames: int) -> str:
    """The framed GEMM kernel's launch for ``frames(x) @ g`` and the rows of
    ``g`` its column tiles (or, in the long launch's slot form, its column
    quads) sum over, as its wrapper chooses them."""
    cut = fg.launch_tiling(x, g, window, overlap, n_frames)
    bands = fg.quad_bands(g, cut.cg) if cut.slots else fg.column_bands(g, cut.cw)
    most = max(_round_up4(hi) - lo // 4 * 4 for lo, hi in bands)
    shown = ", ".join(f"[{lo}, {hi})" for lo, hi in bands[:3]) + (", ..." if len(bands) > 3 else "")
    if cut.band:
        staged = (f"band launch, {cut.group} column tile(s) a CTA, their {cut.rows} rows of G "
                  f"staged " + (f"frame by frame at stride {cut.stride}"
                                if cut.stride != hop_length(window, overlap) else "as one run"))
    elif cut.slots:
        staged = (f"long launch, slot form, each frame in a slot of {cut.stride} floats, two "
                  f"blocks' slots at once, {cut.per_sm} CTA(s) an SM walking the blocks")
    else:
        staged = "long launch, run form, the frames' span staged"
    return (f"launch: {staged}; {fg.launch_ctas(cut, n_frames, fg._sm_count(x.device))} CTAs of "
            f"{cut.frames} frames ({cut.fpt} a thread) and {cut.threads} threads, {cut.n_tiles} "
            f"{'groups of ' + str(cut.cg) + ' column quads' if cut.slots else 'column tiles of ' + str(cut.cw)}"
            f", {cut.ksplit} warps a unit, {cut.span_bytes} B shared, float4 samples "
            f"{cut.vec}; rows of G per {'quad' if cut.slots else 'tile'} {shown}: at most {most} "
            f"of {window}")


def launch_of(x: torch.Tensor, g: torch.Tensor, window: int, overlap: int, n_frames: int) -> str:
    """The framed GEMM's launch in a few words: the launch (band, or the
    long launch's slot or run form), CTAs, frames a CTA (a block, in the
    slot form), column tile or group of quads, row split."""
    cut = fg.launch_tiling(x, g, window, overlap, n_frames)
    kind = "band" if cut.band else "long slots" if cut.slots else "long run"
    cols = (f"{cut.cg} quads" if cut.slots else
            f"tile {cut.cw}{f' x {cut.group}' if cut.band else ''}")
    return (f"{kind} {fg.launch_ctas(cut, n_frames, fg._sm_count(x.device))} CTAs x "
            f"{cut.frames} frames, {cols}, row split {cut.ksplit}")


def _round_up4(v: int) -> int:
    return -(-v // 4) * 4


def register_key(kernel: str) -> str:
    """The ``fused.KERNEL_REGISTERS`` key of a fused detector instantiation
    named as ``ptxas_report`` names it."""
    for layout in ("span", "streamed"):
        if kernel.endswith(" " + layout):
            return layout
    return "resident tc" if " fp32-tc " in kernel else "resident"


def ptxas_report(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill bytes) of every kernel in an nvcc build log
    with ``-Xptxas -v``. A fused detector instantiation is named by its
    template arguments: the wire, the DFT and first-layer arithmetic (fp32,
    fp32-tc with the first layer on the tensor cores, or the tier's bf16
    passes), the input form and, outside the resident layout, "span" or
    "streamed"."""
    wires = {"f": "float32", "s": "int16", "a": "mulaw8"}
    tiers = {(p[0], p[1]): t for t, p in fused.TIERS.items()}
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            m = re.search(r"fused_detector_kernelI([fsa])Li(\d)ELi(n?\d)ELb([01])ELi(\d)E", name)
            if m:
                dft, conv = int(m.group(2)), int(m.group(3).replace("n", "-"))
                tier = ("fp32-tc" if conv == fused.CONV_TF32
                        else tiers.get((dft, conv), "fp32"))
                form = "frames" if m.group(4) == "1" else "samples"
                layout = ("", " span", " streamed")[int(m.group(5))]
                name = f"fused_detector {wires[m.group(1)]} {tier} {form}{layout}"
            out.append([name, -1, -1])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and out:
            out[-1][2] = int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out:
            out[-1][1] = int(regs.group(1))
    return [tuple(k) for k in out]


def run_cli(argv: list[str]) -> tuple[list[str], float, str]:
    """(stdout lines, host seconds, stderr) of one ``cli.main`` run."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue().splitlines(), seconds, err.getvalue()


def compare_csv(got: list[str], want: list[str]) -> float:
    """Columns 1-3 identical, outputs within rtol=1e-4, atol=1e-5; returns
    the largest output difference."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} CSV lines against {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        gp, wp = g.split(","), w.split(",")
        if len(gp) < 4 and g == w:  # a file's path
            continue
        if gp[:3] != wp[:3]:
            raise AssertionError(f"CSV lines differ: {g!r} vs {w!r}")
        a = np.array(gp[3:], np.float64)
        b = np.array(wp[3:], np.float64)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def phase_kernel() -> float:
    worst = 0.0
    for name, cfg, x, rtol, atol in fixtures.fused_cases(10.0):
        spec, params = detector.detector_spec_from_config(cfg, "cuda")
        xd = torch.from_numpy(x).cuda()
        folded = fused.fold_constants(spec, params, "cuda")
        launches = fused.LAUNCHES
        got = fused.fused_offline_outputs(spec, params, xd, folded=folded)
        torch.cuda.synchronize()
        if fused.LAUNCHES != launches + 1 or not got.is_cuda:
            raise AssertionError(f"{name}: the kernel was not launched")
        plain = fused.fused_offline_outputs_reference(spec, folded, xd)
        unfused = detector.offline_outputs(spec, params, xd)
        g, p, u = (t.cpu().numpy() for t in (got, plain, unfused))
        if g.shape != p.shape or g.shape != u.shape or not len(g):
            raise AssertionError(f"{name}: shapes {g.shape} {p.shape} {u.shape}")
        for want in (p, u):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(want), err_msg=name)
            np.testing.assert_allclose(g, want, rtol=rtol, atol=atol, err_msg=name)
        finite = np.isfinite(p)
        abs_err = np.abs(g - p)[finite]
        rel_err = abs_err / np.maximum(np.abs(p[finite]), 1e-30)
        worst = max(worst, float(abs_err.max()))
        print(
            f"phase 3 kernel {name}: evals {len(g)}, NaN {int((~finite).sum())}, "
            f"vs plain max_abs {abs_err.max():.3g} max_rel {rel_err.max():.3g}, "
            f"vs unfused max_abs {np.abs(g - u)[finite].max():.3g} "
            f"(rtol={rtol}, atol={atol}) ok",
            flush=True,
        )
    return worst


def phase_main(tmp: str) -> int:
    audio = np.stack([fixtures.chirp_audio(4.0, 11), fixtures.chirp_audio(4.0, 12)], 1)
    cfg = fixtures.pick_thresholds(fixtures.sample_geometry_config(0), audio)
    net, wav = os.path.join(tmp, "net.txt"), os.path.join(tmp, "two.wav")
    save_config(cfg, net)
    write_wav(wav, audio, int(cfg.sampling_rate), dtype="float32")
    argv = ["-n", net, "-a", wav, "--device", "cuda"]

    fused.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    fused_csv = run_cli(argv + ["--method", "fused"])[0]
    launches = fused.LAUNCHES
    fused_bytes = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    matmul_csv = run_cli(argv + ["--method", "matmul"])[0]
    matmul_bytes = torch.cuda.max_memory_allocated()

    if launches <= 0:
        raise AssertionError("the fused CLI run launched no kernel")
    if fused_bytes <= 0 or matmul_bytes <= 0:
        raise AssertionError("the CLI runs allocated nothing on the card")
    n_evals = num_frames(len(audio), cfg.window_length, cfg.window_overlap) - cfg.time_range + 1
    per_channel = [sum(line.startswith(f"{c},") for line in fused_csv) for c in (0, 1)]
    if not 0 < sum(per_channel) < 2 * n_evals:
        raise AssertionError(f"detections {per_channel} of {n_evals} evals per channel")
    worst = compare_csv(fused_csv, matmul_csv)
    print(
        f"phase 4 main path: cli --method fused vs matmul on 2 x {len(audio)} samples: "
        f"{len(fused_csv)} detection lines (per channel {per_channel} of {n_evals} evals), "
        f"columns 1-3 identical, outputs max diff {worst:.3g}; fused kernel launches "
        f"{launches}; peak card memory fused {fused_bytes} B, matmul {matmul_bytes} B ok",
        flush=True,
    )
    return launches


def phase_times(tmp: str, card_line: str) -> tuple[float, float, tuple[float, str]]:
    """(kernel ms, plain ms, bound) of the 60 s stream."""
    cfg = fixtures.sample_geometry_config(0)
    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    folded = fused.fold_constants(spec, params, "cuda")
    x = fixtures.chirp_audio(60.0, 21)
    # the 60 s stream, and the samples one CLI drain step hands the kernel
    # (a 65536-sample chunk plus the retained T-1 hops)
    chunk = (cli.CHUNK // spec.hop + spec.time_range - 1) * spec.hop + spec.window_length
    results = {}
    for name, n in (("60 s stream", len(x)), ("CLI chunk", chunk)):
        xd = torch.from_numpy(x[:n]).cuda()
        n_evals = num_frames(n, cfg.window_length, cfg.window_overlap) - cfg.time_range + 1
        kernel = event_ms(lambda: fused.fused_offline_outputs(spec, params, xd, folded=folded))
        plain = event_ms(lambda: fused.fused_offline_outputs_reference(spec, folded, xd))
        least = fused_bound(spec, 1, n, 4, 1)
        results[name] = (kernel[0], plain[0], least)
        print(
            f"phase 5 times [{card_line}]: {name} ({n} samples, {n_evals} evals), "
            f"median of 21 x 10 calls: kernel {kernel[0]:.4f} ms device "
            f"({kernel[1]:.4f} ms host enqueue), plain fused {plain[0]:.4f} ms device "
            f"({plain[1]:.4f} ms host enqueue); bound {least[0]:.4f} ms ({least[1]}); "
            f"tile: {tile_of(spec, 1, n)}",
            flush=True,
        )
    net, wav = os.path.join(tmp, "net60.txt"), os.path.join(tmp, "sixty.wav")
    save_config(fixtures.pick_thresholds(cfg, x), net)
    write_wav(wav, x, int(cfg.sampling_rate), dtype="float32")
    for method in ("fused", "matmul"):
        argv = ["-n", net, "-a", wav, "--device", "cuda", "--method", method]
        run_cli(argv)  # warm-up
        runs = [run_cli(argv)[1] for _ in range(3)]
        print(
            f"phase 5 times [{card_line}]: cli --method {method} on the 60 s file, "
            f"host clock median of 3 runs {statistics.median(runs):.4f} s "
            f"(runs {', '.join(f'{r:.4f}' for r in runs)})",
            flush=True,
        )
    return results["60 s stream"]


def bucket_samples(spec, bucket: int) -> int:
    """Samples per lane of one drain round of ``bucket`` evaluations."""
    return (bucket + spec.time_range - 2) * spec.hop + spec.window_length


def to_wire(x: np.ndarray, wire: str) -> np.ndarray:
    """Float samples on the bank's wire: clip and round to int16, then the
    mu-law table for the 8-bit wire (DetectorBank's staging)."""
    if wire == "float32":
        return x
    q = np.rint(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    return q if wire == "int16" else _mulaw_lut()[q.astype(np.int32) + 32768]


def reset_counts() -> None:
    fused.LAUNCHES = 0
    fused.BATCH_LAUNCHES = 0
    fused.PROGRAM_LAUNCHES = {wire: 0 for wire in fused.PROGRAM_LAUNCHES}
    fused.TIER_LAUNCHES = {tier: 0 for tier in fused.TIER_LAUNCHES}
    fused.FRAMES_LAUNCHES = 0
    fused.GRID_LAUNCHES = 0
    fused.LAYOUT_LAUNCHES = {layout: 0 for layout in fused.LAYOUT_LAUNCHES}
    fg.FRAMED_GEMM_LAUNCHES = 0
    fg.LAUNCH_KINDS = {kind: 0 for kind in fg.LAUNCH_KINDS}
    trainer.EPOCH_GRAPHS = {"captures": 0, "replays": 0}


def program_launches(wire: str) -> int:
    return fused.BATCH_LAUNCHES if wire == "float32" else fused.PROGRAM_LAUNCHES[wire]


def phase_batch(pairs) -> dict:
    """The batched kernel against its plain version; returns the largest
    absolute difference per wire."""
    spec = pairs[0][0]
    params = [p for _, p in pairs]
    rng = np.random.default_rng(6)
    ragged = bucket_samples(spec, 37) + 55
    cases = [
        (f"{LANES} x 128", LANES, bucket_samples(spec, 128), None),
        (f"{LANES} x 8", LANES, bucket_samples(spec, 8), None),
        ("3 ragged", 3, ragged, (ragged, 3000, 1500)),
    ]
    worst = {wire: 0.0 for wire in WIRES}
    for name, lanes, n, valid in cases:
        x = rng.uniform(-0.7, 0.7, (lanes, n)).astype(np.float32)
        if valid is not None:
            for lane, m in enumerate(valid):
                x[lane, m:] = 0.0  # the bank's zero tails: NaN under l2normalize
        n_evals = num_frames(n, spec.window_length, spec.window_overlap) - spec.time_range + 1
        folds = {
            "per-lane": fused.fold_constants_stacked(spec, params[:lanes], "cuda"),
            "shared": fused.fold_constants(spec, params[0], "cuda"),
        }
        for wire in WIRES:
            xd = torch.from_numpy(to_wire(x, wire)).cuda()
            for nets, folded in folds.items():
                prog = fused.BatchProgram(spec, folded, lanes, n, n_evals, wire, "cuda")
                before = program_launches(wire)
                got = prog.launch(xd)
                torch.cuda.synchronize()
                if program_launches(wire) != before + 1 or not got.is_cuda:
                    raise AssertionError(f"{name} {wire} {nets}: the kernel was not launched")
                plain = fused.fused_batch_outputs_reference(spec, folded, xd, wire, n_evals)
                g, p = got.cpu().numpy(), plain.cpu().numpy()
                if g.shape != (lanes, n_evals, spec.net.outputs) or g.shape != p.shape:
                    raise AssertionError(f"{name}: shapes {g.shape} {p.shape}")
                np.testing.assert_array_equal(np.isnan(g), np.isnan(p), err_msg=name)
                np.testing.assert_allclose(g, p, rtol=1e-3, atol=2e-4, err_msg=f"{name} {wire}")
                nan = np.isnan(g)
                if valid is not None and not (nan[1:].any() and not nan[0].any()):
                    raise AssertionError(f"{name}: NaN not in the zero tails only")
                finite = ~nan
                err = float(np.abs(g - p)[finite].max())
                worst[wire] = max(worst[wire], err)
                print(
                    f"phase 6 batch {name} ({n} samples, {n_evals} evals) {wire} {nets} nets: "
                    f"NaN {int(nan.sum())}, vs plain max_abs {err:.3g} "
                    f"(rtol=1e-3, atol=2e-4) ok",
                    flush=True,
                )
    return worst


def drain_all(bank, audio, gap_at, gap_len, chunks):
    """Feed every lane ``chunks`` capture chunks of ``audio`` (lanes with
    lane % 4 == 0 lose ``gap_len`` samples before chunk ``gap_at``),
    draining after each; returns per-lane (outputs, sample indices) and
    the host seconds of each drain call."""
    lanes = bank.n_lanes
    pos = [0] * lanes
    outs = [[] for _ in range(lanes)]
    idx = [[] for _ in range(lanes)]
    seconds = []

    def collect(flush=False):
        t0 = time.perf_counter()
        out = bank.drain(flush=flush)
        seconds.append(time.perf_counter() - t0)
        for lane in range(lanes):
            c = int(bank.last_counts[lane])
            if c:
                outs[lane].append(out[lane, :c])
                idx[lane].append(bank.last_sample_indices[lane])
            if np.isnan(out[lane, c:]).any():
                raise AssertionError("a padding row reached the result")

    for k in range(chunks):
        for lane in range(lanes):
            if k == gap_at and lane % 4 == 0:
                bank.note_gap(lane, gap_len)
                pos[lane] += gap_len
            bank.append_audio_data(lane, audio[pos[lane] : pos[lane] + CHUNK])
            pos[lane] += CHUNK
        collect()
    collect(flush=True)
    return [np.concatenate(o) for o in outs], [np.concatenate(i) for i in idx], seconds


def compare_lanes(got, want, what: str) -> float:
    worst = 0.0
    for lane, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(got[1][lane], want[1][lane], err_msg=f"{what} lane {lane}")
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} lane {lane}")
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-4, err_msg=f"{what} lane {lane}")
        finite = np.isfinite(g)
        worst = max(worst, float(np.abs(g - w)[finite].max()))
    return worst


def run_monitor(argv: list[str]) -> tuple[list[str], float]:
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = monitor.main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:  # also when any drain failed
        raise RuntimeError(f"monitor.main returned {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue().splitlines(), seconds


def read_events(path: str) -> list[list[str]]:
    with open(path) as fh:
        rows = [line.split(",") for line in fh.read().splitlines()]
    return sorted(rows, key=lambda r: (int(r[0]), int(r[1])))


def compare_events(got: str, want: str, what: str) -> tuple[int, float]:
    g, w = read_events(got), read_events(want)
    if [r[:3] for r in g] != [r[:3] for r in w]:
        raise AssertionError(f"{what}: event logs differ ({len(g)} against {len(w)} rows)")
    if not g:
        raise AssertionError(f"{what}: no event")
    a = np.array([r[3:] for r in g], np.float64)
    b = np.array([r[3:] for r in w], np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4, err_msg=what)
    return len(g), float(np.abs(a - b).max())


def phase_live(tmp: str, cfgs, audio, card_line: str) -> dict:
    """The live path at full width; returns the main-path launch counts and
    the 256-lane monitor's audio seconds per wall second."""
    spec = detector.detector_spec_from_config(cfgs[0], "cpu")[0]
    chunks = len(audio) // CHUNK
    gap_at = chunks // 2
    # a gap whose far side lands on the hop grid of the whole stream, so
    # that the thresholds' margins hold on both sides of it
    gap_len = (-(gap_at * CHUNK)) % spec.hop + 10 * spec.hop
    results = {}
    for name, kw in (
        ("fused, ladder (128,)", dict(method="fused", buckets=(128,))),
        ("fused, default ladder", dict(method="fused")),
        ("matmul", dict(method="matmul")),
    ):
        bank = DetectorBank(cfgs, transfer_dtype="int16", device="cuda", **kw)
        reset_counts()
        t0 = time.perf_counter()
        results[name] = drain_all(bank, audio, gap_at, gap_len, chunks)
        wall = time.perf_counter() - t0
        launches = fused.PROGRAM_LAUNCHES["int16"]
        if (kw["method"] == "fused") != (launches > 0):
            raise AssertionError(f"bank {name}: {launches} int16 launches")
        rows = sum(len(o) for o in results[name][0])
        print(
            f"phase 7 live bank {name} [{card_line}]: {LANES} lanes x {chunks} chunks of "
            f"{CHUNK} int16 samples, gap of {gap_len} on every 4th lane: {rows} outputs in "
            f"{len(results[name][2])} drains, {wall:.2f} s; int16 launches {launches} ok",
            flush=True,
        )
    for name in ("fused, ladder (128,)", "fused, default ladder"):
        worst = compare_lanes(results[name], results["matmul"], name)
        print(f"phase 7 live bank {name} vs matmul: indices equal, max_abs {worst:.3g} ok", flush=True)

    wav = os.path.join(tmp, "live.wav")
    write_wav(wav, audio, int(spec.sampling_rate), dtype="float32")
    nets = []
    for i, cfg in enumerate(cfgs):
        nets.append(os.path.join(tmp, f"live{i}.txt"))
        save_config(cfg, nets[-1])
    seconds = 8.0  # under the 10 s rings, so no ring overflow
    common = ["-a", wav, "--duration", str(seconds), "--frame-size", str(CHUNK),
              "--refresh", "600", "--device", "cuda"]
    launches = {}

    def monitor_pair(tag, argv_a, argv_b, count):
        logs = []
        for i, argv in enumerate((argv_a, argv_b)):
            log = os.path.join(tmp, f"{tag}{i}.csv")
            reset_counts()
            out, wall = run_monitor(argv + ["--event-log", log])
            if i == 0:
                launches[tag] = count()
                if launches[tag] <= 0:
                    raise AssertionError(f"monitor {tag}: the kernel was not launched")
                first = (out, wall)
            logs.append(log)
        rows, worst = compare_events(logs[0], logs[1], tag)
        return first, rows, worst

    all_nets = [a for n in nets for a in ("-n", n)]
    batched = ["--channels", str(LANES), "--batched-drain", "--wire-format", "int16",
               "--buckets", "128"]
    (out, wall), rows, worst = monitor_pair(
        "int16", all_nets + common + batched,
        all_nets + common + batched + ["--method", "matmul"],
        lambda: fused.PROGRAM_LAUNCHES["int16"],
    )
    rate = LANES * seconds / wall
    print(
        f"phase 7 live monitor [{card_line}]: --channels {LANES} --batched-drain "
        f"--wire-format int16 --buckets 128, fused vs matmul: {rows} events equal in columns "
        f"1-3, outputs max diff {worst:.3g}, int16 launches {launches['int16']}, drain errors 0; "
        f"{seconds} s of audio per channel in {wall:.2f} s ok",
        flush=True,
    )
    eight = [a for n in nets[:8] for a in ("-n", n)] + common[:2] + [
        "--duration", "3", "--frame-size", str(CHUNK), "--refresh", "600",
        "--device", "cuda", "--channels", "8"]
    (_, _), rows, worst = monitor_pair(
        "float32", eight + ["--batched-drain"], eight + ["--method", "fused"],
        lambda: fused.BATCH_LAUNCHES,
    )
    launches["per-lane"] = fused.LAUNCHES
    if launches["per-lane"] <= 0:
        raise AssertionError("the per-lane fused monitor launched no kernel")
    print(
        f"phase 7 live monitor: 8 channels --batched-drain (float32 wire) vs per lane "
        f"--method fused: {rows} events equal in columns 1-3, outputs max diff {worst:.3g}; "
        f"batch launches {launches['float32']}, per-lane launches {launches['per-lane']}, "
        f"drain errors 0 ok",
        flush=True,
    )

    # the mu-law wire quantises coarsely: thresholds are picked on the audio
    # the nets see through it
    heard = mulaw_expand_np(to_wire(audio, "mulaw8"))
    mu_nets = []
    for i, cfg in enumerate(cfgs[:8]):
        mu_nets += ["-n", os.path.join(tmp, f"mu{i}.txt")]
        save_config(fixtures.pick_thresholds(cfg, heard[: 3 * 44100], device="cuda"), mu_nets[-1])
    mu = mu_nets + eight[16:] + ["--batched-drain", "--wire-format", "mulaw8"]
    (_, _), rows, worst = monitor_pair(
        "mulaw8", mu, mu + ["--method", "matmul"], lambda: fused.PROGRAM_LAUNCHES["mulaw8"]
    )
    print(
        f"phase 7 live monitor: 8 channels --wire-format mulaw8 fused vs matmul: {rows} events "
        f"equal in columns 1-3, outputs max diff {worst:.3g}; mulaw8 launches "
        f"{launches['mulaw8']}, drain errors 0 ok",
        flush=True,
    )
    return {"launches": launches, "audio_per_wall": rate}


def phase_live_times(cfgs, audio, card_line: str) -> dict:
    """Device times of one 256 x 128 round per wire, and the host's time
    per bank.drain() round, split."""
    pairs = [detector.detector_spec_from_config(c, "cuda") for c in cfgs]
    spec = pairs[0][0]
    n = bucket_samples(spec, 128)
    n_evals = 128
    folded = fused.fold_constants_stacked(spec, [p for _, p in pairs], "cuda")
    x = np.stack([np.roll(audio, 97 * lane)[:n] for lane in range(LANES)])
    times = {}
    for wire in WIRES:
        xd = torch.from_numpy(to_wire(x, wire)).cuda()
        prog = fused.BatchProgram(spec, folded, LANES, n, n_evals, wire, "cuda")
        kernel = event_ms(lambda: prog.launch(xd))
        plain = event_ms(lambda: fused.fused_batch_outputs_reference(spec, folded, xd, wire, n_evals))
        least = fused_bound(spec, LANES, n, xd.element_size(), LANES)
        times[wire] = (kernel[0], plain[0], least)
        print(
            f"phase 8 times [{card_line}]: one {LANES} x 128 round ({n} {wire} samples per lane, "
            f"{LANES * n_evals} evals), median of 21 x 10 calls: kernel {kernel[0]:.4f} ms device "
            f"({kernel[1]:.4f} ms host enqueue), plain {plain[0]:.4f} ms device "
            f"({plain[1]:.4f} ms host enqueue); bound {least[0]:.4f} ms ({least[1]}); "
            f"tile: {tile_of(spec, LANES, n)}",
            flush=True,
        )

    bank = DetectorBank(cfgs, transfer_dtype="int16", buckets=(128,), device="cuda")
    bank.warm_up()
    prog = bank._program(n)
    stager = bank._stager
    if stager is None:
        raise AssertionError("the native drain stager did not build")
    hop_block = 128 * spec.hop
    for lane in range(LANES):  # the retained context, then 128 hops per round
        bank.append_audio_data(lane, audio[: n - hop_block])
    split = {label: {k: [] for k in ("stage", "copy", "launch", "readback", "drain")}
             for label in ("native", "numpy")}
    r = 0
    # the two stagings in turns, 4 x 11 rounds
    for label in ("native", "numpy", "numpy", "native"):
        bank._stager = stager if label == "native" else None
        for _ in range(11):
            start = (r * hop_block) % (len(audio) - hop_block)
            r += 1
            for lane in range(LANES):
                bank.append_audio_data(lane, audio[start : start + hop_block])
            avail = [bank._front_avail(lane) for lane in range(LANES)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs = bank._stage_round(avail, n)
            t1 = time.perf_counter()
            xd = prog.upload(xs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = prog.launch(xd)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            out.cpu().numpy()
            t4 = time.perf_counter()
            bank.drain()
            t5 = time.perf_counter()
            if int(bank.last_counts.min()) != 128:
                raise AssertionError(f"round {r}: counts {bank.last_counts.min()}")
            for k, v in zip(("stage", "copy", "launch", "readback", "drain"),
                            (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                split[label][k].append(v * 1e3)
    bank._stager = stager
    for label, parts in split.items():
        med = {k: statistics.median(v) for k, v in parts.items()}
        print(
            f"phase 8 times [{card_line}]: host per bank.drain() round ({LANES} lanes, int16 "
            f"wire, bucket 128, {LANES * n * 2} wire bytes), {label} staging, median of 22: "
            f"whole drain {med['drain']:.3f} ms; staging {med['stage']:.3f} ms, host->device "
            f"copy {med['copy']:.3f} ms, launch to completion {med['launch']:.3f} ms, "
            f"device->host copy {med['readback']:.3f} ms",
            flush=True,
        )
    return times


def rate_name(in_rate: float, out_rate: float) -> str:
    return f"{in_rate / 1000:g}k->{out_rate / 1000:g}k"


def phase_resample_kernel() -> float:
    """The framed GEMM kernel against its plain version on 60 s inputs,
    and the resampler on the card against the resampler on the CPU;
    returns the kernel's largest absolute difference."""
    rng = np.random.default_rng(9)
    cases = []
    for in_rate, out_rate in fixtures.RESAMPLE_PAIRS:
        x = fixtures.chirp_audio(CORPUS_SECONDS, 90, rate=int(in_rate))
        on_card = resample.polyphase_resample(x, in_rate, out_rate, device="cuda").cpu().numpy()
        on_cpu = resample.polyphase_resample(x, in_rate, out_rate, device="cpu").numpy()
        np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)
        xin, g, w_len, overlap, frames, _ = resample.polyphase_framing(
            x, in_rate, out_rate, device="cuda"
        )
        cases.append((rate_name(in_rate, out_rate), xin, g, w_len, overlap, frames))
    # a long hop on a 60 s channel: the long launch's slot form
    for in_rate, out_rate in LONG_PAIRS[:1]:
        x = fixtures.chirp_audio(CORPUS_SECONDS, 94, rate=in_rate)
        xin, g, w_len, overlap, frames, _ = resample.polyphase_framing(
            x, in_rate, out_rate, device="cuda")
        cases.append((f"{rate_name(in_rate, out_rate)} {CORPUS_SECONDS:g} s", xin, g, w_len,
                      overlap, frames))
    # a short channel: the band launch
    for in_rate, out_rate in ((48000, 11025), (96000, 44100)):
        x = fixtures.chirp_audio(SHORT_SECONDS, 93, rate=in_rate)
        xin, g, w_len, overlap, frames, _ = resample.polyphase_framing(
            x, in_rate, out_rate, device="cuda")
        if not fg.launch_tiling(xin, g, w_len, overlap, frames).band:
            raise AssertionError(f"{rate_name(in_rate, out_rate)} on {SHORT_SECONDS:g} s: "
                                 f"not the band launch")
        cases.append((f"{rate_name(in_rate, out_rate)} {SHORT_SECONDS:g} s", xin, g, w_len,
                      overlap, frames))
    noise = torch.from_numpy(
        rng.standard_normal(int(CORPUS_SECONDS * NET_RATE)).astype(np.float32)
    ).cuda()
    for window, overlap in fixtures.FRAMED_GEMM_GEOMETRIES:
        g = torch.from_numpy(rng.standard_normal((window, 24)).astype(np.float32)).cuda()
        frames = num_frames(noise.numel(), window, overlap) + 3  # a zero-padded tail
        cases.append((f"window {window} overlap {overlap}", noise, g, window, overlap, frames))
    worst, forms = 0.0, set()
    for name, x, g, window, overlap, frames in cases:
        cut = fg.launch_tiling(x, g, window, overlap, frames)
        forms.add("band" if cut.band else "slots" if cut.slots else "run")
        before = fg.FRAMED_GEMM_LAUNCHES
        got = fg.framed_gemm(x, g, window, overlap, frames)
        torch.cuda.synchronize()
        if fg.FRAMED_GEMM_LAUNCHES != before + 1 or not got.is_cuda:
            raise AssertionError(f"{name}: the kernel was not launched")
        plain = fg.framed_gemm_reference(x, g, window, overlap, frames)
        a, b = got.cpu().numpy(), plain.cpu().numpy()
        if a.shape != (frames, g.shape[1]) or a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"{name}: shapes {a.shape} {b.shape}")
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        err = float(np.abs(a - b).max())
        worst = max(worst, err)
        # a NaN, an Inf and a -Inf in the samples: the dense product has NaN
        # in every column of their frames wherever G has a zero, and so must
        # the kernel, which skips G's zeros on finite spans only
        bad = x.clone()
        spots = (x.numel() // 7, x.numel() // 2, x.numel() - window // 2)
        for at, v in zip(spots, (float("nan"), float("inf"), float("-inf"))):
            bad[at] = v
        a = fg.framed_gemm(bad, g, window, overlap, frames).cpu().numpy()
        b = fg.framed_gemm_reference(bad, g, window, overlap, frames).cpu().numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{name} non-finite")
        np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b), err_msg=f"{name} non-finite")
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b), err_msg=f"{name} non-finite")
        finite = np.isfinite(b)
        np.testing.assert_allclose(a[finite], b[finite], rtol=1e-4, atol=1e-4, err_msg=name)
        if not 0 < int(np.isnan(b).sum()) < b.size // 2:
            raise AssertionError(f"{name}: {int(np.isnan(b).sum())} NaN in the plain version")
        hop = hop_length(window, overlap)
        ms = event_ms(lambda: fg.framed_gemm(x, g, window, overlap, frames), samples=7)[0]
        print(
            f"phase 9 resample kernel {name}: [{x.numel()}] x [{window}, {g.shape[1]}] -> "
            f"[{frames}, {g.shape[1]}] (hop {hop}), vs plain "
            f"max_abs {err:.3g} (rtol=1e-4, atol=1e-4); with a NaN, an Inf and a -Inf in the "
            f"samples: {int(np.isnan(b).sum())} NaN, {int(np.isinf(b).sum())} Inf in the same "
            f"places; kernel {ms:.4f} ms device; {tiling_of(x, g, window, overlap, frames)} ok",
            flush=True,
        )
    if forms != {"band", "slots", "run"}:
        raise AssertionError(f"phase 9 held the framed GEMM in {sorted(forms)} only")
    return worst


def group_lines(lines: list[str], paths: list[str]) -> dict:
    """The CLI's output as {(file, channel): its lines, in order}."""
    groups, path = {}, None
    for line in lines:
        if line in paths:
            path = line
        else:
            groups.setdefault((path, line.split(",")[0]), []).append(line)
    return groups


def corpus_fixture(tmp: str) -> tuple[list[str], list[str]]:
    """(files, nets) of the corpus scan, written into ``tmp``: CORPUS_FILES
    seeded two-channel chirp files at CORPUS_RATES, and 4 seeded nets whose
    thresholds lie at least the kernel's atol from every output they give
    on what they hear (the files resampled to NET_RATE on the card)."""
    files, heard = [], []
    for i in range(CORPUS_FILES):
        rate = CORPUS_RATES[i % len(CORPUS_RATES)]
        chans = [fixtures.chirp_audio(CORPUS_SECONDS, 300 + 2 * i + c, rate=rate) for c in range(2)]
        files.append(os.path.join(tmp, f"corpus{i}_{rate}.wav"))
        write_wav(files[-1], np.stack(chans, 1), rate, dtype="float32")
        for x in chans:
            if rate != NET_RATE:  # the nets hear the file resampled
                x = resample.polyphase_resample(x, rate, NET_RATE, device="cuda").cpu().numpy()
            heard.append(x)
    heard = np.stack(heard, 1)
    # a wider margin than the kernel's atol leaves only the far tail of ~320 k
    # outputs, and few detections
    nets = []
    for seed in range(4):
        cfg = fixtures.sample_geometry_config(seed)
        nets.append(os.path.join(tmp, f"corpus_net{seed}.txt"))
        save_config(fixtures.pick_thresholds(cfg, heard, margin=2e-4, device="cuda"), nets[-1])
    return files, nets


def phase_corpus(tmp: str) -> dict:
    """The batched corpus scan and its comparisons; returns the main path's
    launch counts and the arguments of its runs."""
    files, nets = corpus_fixture(tmp)
    resampled_files = sum(CORPUS_RATES[i % len(CORPUS_RATES)] != NET_RATE for i in range(CORPUS_FILES))
    audio = [a for f in files for a in ("-a", f)] + ["--device", "cuda"]
    one = ["-n", nets[0]] + audio
    four = [a for n in nets for a in ("-n", n)] + audio

    # the slice's main path, with every count from 0
    reset_counts()
    batched, wall, err = run_cli(one + ["--batched", "--method", "fused"])
    k2, k1e = fg.FRAMED_GEMM_LAUNCHES, fused.BATCH_LAUNCHES
    if k2 != 2 * resampled_files:
        raise AssertionError(f"{k2} resampler launches for {2 * resampled_files} resampled channels")
    if k1e <= 0:
        raise AssertionError("the batched scan did not launch the batched kernel")
    if err.count("Resampling ") != resampled_files:
        raise AssertionError(f"unexpected stderr: {err[-2000:]}")
    groups = group_lines(batched, files)
    per_channel = [len(groups.get((f, str(c)), ())) for f in files for c in (0, 1)]
    if sum(per_channel) < 100 or len(batched) != len(files) + sum(per_channel):
        raise AssertionError(f"detections per channel {per_channel}")
    print(
        f"phase 10 corpus main path: cli --batched --method fused on {len(files)} files x 2 "
        f"channels x {CORPUS_SECONDS:g} s at {'/'.join(str(r) for r in CORPUS_RATES)} Hz "
        f"({2 * len(files)} lanes): {sum(per_channel)} detection lines (per channel "
        f"{per_channel}) in {wall:.2f} s; resampler launches {k2} for {2 * resampled_files} "
        f"resampled channels, batched kernel launches {k1e} ok",
        flush=True,
    )

    matmul = run_cli(one + ["--batched", "--method", "matmul"])[0]
    worst = compare_csv(batched, matmul)
    sequential = run_cli(one + ["--method", "fused"])[0]
    seq_groups = group_lines(sequential, files)
    if seq_groups.keys() != groups.keys():
        raise AssertionError("the sequential and batched scans detect on other channels")
    for key, lines in groups.items():
        worst = max(worst, compare_csv(lines, seq_groups[key]))
    if run_cli(one + ["--batched", "--method", "fused", "--batch-files", "3"])[0] != batched:
        raise AssertionError("--batch-files 3 changed the batched output")
    reset_counts()
    per_lane = run_cli(four + ["--batched", "--method", "fused"])[0]
    if fused.BATCH_LAUNCHES <= 0:
        raise AssertionError("the per-lane batched scan did not launch the batched kernel")
    per_lane_matmul = run_cli(four + ["--batched", "--method", "matmul"])[0]
    worst = max(worst, compare_csv(per_lane, per_lane_matmul))
    if per_lane == batched:
        raise AssertionError("four nets gave the one net's detections")
    print(
        f"phase 10 corpus: --batched fused vs matmul vs sequential fused per channel group, "
        f"--batch-files 3 equal to ungrouped, 4 per-lane nets fused vs matmul "
        f"({len(per_lane) - len(files)} lines): columns 1-3 identical, outputs max diff "
        f"{worst:.3g} ok",
        flush=True,
    )

    signal = {}
    for method in ("fused", "matmul"):
        out = os.path.join(tmp, f"sim_{method}.wav")
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = sim.main(["-n", nets[0], "-a", files[0], "--channel", "1", "-o", out,
                           "--method", method, "--device", "cuda"])
        if rc != 0 or (method == "fused") != (fused.LAUNCHES > 0):
            raise AssertionError(f"sim --method {method}: rc {rc}, launches {fused.LAUNCHES}")
        signal[method] = read_audio(out)[0][:, 0]
    diff = float(np.abs(signal["fused"] - signal["matmul"]).max())
    if diff > 1.5 / 32768 or not (signal["fused"] > 0.99).any():
        raise AssertionError(f"sim fused vs matmul: max diff {diff}")
    print(
        f"phase 10 corpus: sim --method fused vs matmul on {len(signal['fused'])} samples: "
        f"{int(np.count_nonzero(signal['fused']))} non-zero, max diff {diff:.3g} ok",
        flush=True,
    )
    return {"k2": k2, "k1e": k1e, "one": one, "net": nets[0], "files": files,
            "nets": nets, "batched": batched}


def phase_corpus_times(scan: dict, card_line: str) -> dict:
    """Times of the framed GEMM kernel per 60 s channel, the corpus walls
    and the batched scan's steps; returns (kernel, plain, library, bound)
    per input rate."""
    results = {}
    for in_rate in (48000, 96000):
        x = fixtures.chirp_audio(CORPUS_SECONDS, 91, rate=in_rate)
        xin, g, w_len, overlap, frames, _ = resample.polyphase_framing(
            x, in_rate, NET_RATE, device="cuda"
        )
        hop = hop_length(w_len, overlap)
        need = (frames - 1) * hop + w_len  # the resampler's overlap is never a gap
        xpad = torch.cat([xin, xin.new_zeros(max(0, need - xin.numel()))])[:need]
        torch.testing.assert_close(
            xpad.unfold(0, w_len, hop) @ g, fg.framed_gemm(xin, g, w_len, overlap, frames),
            rtol=1e-4, atol=1e-4,
        )
        kernel = event_ms(lambda: fg.framed_gemm(xin, g, w_len, overlap, frames))
        plain = event_ms(lambda: fg.framed_gemm_reference(xin, g, w_len, overlap, frames))
        library = event_ms(lambda: xpad.unfold(0, w_len, hop) @ g)
        least = framed_bound(xin, g, frames)
        whole = []
        for _ in range(5):
            t0 = time.perf_counter()
            resample.polyphase_resample(x, in_rate, NET_RATE, device="cuda").cpu()
            whole.append((time.perf_counter() - t0) * 1e3)
        results[in_rate] = (kernel, plain, library, least)
        print(
            f"phase 11 times [{card_line}]: resampler {rate_name(in_rate, NET_RATE)}, one "
            f"{CORPUS_SECONDS:g} s channel ([{xin.numel()}] x [{w_len}, {g.shape[1]}] -> "
            f"[{frames}, {g.shape[1]}]), median of 21 x 10 calls: kernel {kernel[0]:.4f} ms "
            f"device ({kernel[1]:.4f} ms host enqueue), plain {plain[0]:.4f} ms device "
            f"({plain[1]:.4f} ms host enqueue), library unfold @ g {library[0]:.4f} ms device "
            f"({library[1]:.4f} ms host enqueue); bound {least[0]:.4f} ms ({least[1]}); "
            f"{tiling_of(xin, g, w_len, overlap, frames)}; whole "
            f"polyphase_resample from numpy to numpy, host clock median of 5: "
            f"{statistics.median(whole):.3f} ms",
            flush=True,
        )
    walls = {"batched": [], "sequential": []}
    for mode in ("batched", "sequential", "sequential", "batched"):
        argv = scan["one"] + ["--method", "fused"] + (["--batched"] if mode == "batched" else [])
        walls[mode].append(run_cli(argv)[1])
    print(
        f"phase 11 times [{card_line}]: the corpus ({CORPUS_FILES} files x 2 channels x "
        f"{CORPUS_SECONDS:g} s), host clock, in turns: cli --batched --method fused "
        f"{', '.join(f'{s:.3f}' for s in walls['batched'])} s; sequential cli --method fused "
        f"{', '.join(f'{s:.3f}' for s in walls['sequential'])} s",
        flush=True,
    )
    # the batched scan's steps, as corpus.scan_corpus_files takes them
    cfg = load_config(scan["net"])
    steps, t0 = {}, time.perf_counter()
    audio = [read_audio(f) for f in scan["files"]]
    steps["read"] = time.perf_counter()
    streams = []
    for samples, rate in audio:
        if rate != NET_RATE:
            samples = corpus.resample_channels(samples, rate, NET_RATE, "cuda")
        streams += [np.ascontiguousarray(samples[:, c]) for c in range(samples.shape[1])]
    steps["resample"] = time.perf_counter()
    outs = corpus.scan_corpus(cfg, streams, method="fused", device="cuda")
    steps["scan"] = time.perf_counter()
    lines = sum(len(corpus.corpus_csv_lines(cfg, o, channel=i % 2)) for i, o in enumerate(outs))
    steps["csv"] = time.perf_counter()
    split = []
    for name, t in steps.items():
        split.append(f"{name} {t - t0:.3f} s")
        t0 = t
    # the batched kernel on the scan's padded lanes, against its plain
    # version on the same tensor: every evaluation, the zero padding's too
    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    xs = torch.zeros((len(streams), corpus._bucket(max(len(s) for s in streams))), device="cuda")
    for i, s in enumerate(streams):
        xs[i, : len(s)] = torch.from_numpy(s)
    folded = fused.fold_constants(spec, params, "cuda")
    got = fused.fused_flat_batch_offline_outputs(spec, params, xs, folded=folded).cpu().numpy()
    plain_out = fused.fused_batch_outputs_reference(spec, folded, xs).cpu().numpy()
    n_evals = num_frames(xs.shape[1], spec.window_length, spec.window_overlap) - spec.time_range + 1
    if got.shape != (len(streams), n_evals, spec.net.outputs) or got.shape != plain_out.shape:
        raise AssertionError(f"corpus scan: shapes {got.shape} {plain_out.shape}")
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(plain_out), err_msg="corpus scan")
    np.testing.assert_allclose(got, plain_out, rtol=1e-4, atol=1e-5, err_msg="corpus scan")
    # NaN comes only from all-zero windows (l2normalize): the chirps' digital
    # silence and the padding past each lane's audio, never a whole lane
    audible = [num_frames(len(s), spec.window_length, spec.window_overlap) - spec.time_range + 1
               for s in streams]
    if not all(np.isfinite(got[i, :e]).mean() > 0.9 for i, e in enumerate(audible)):
        raise AssertionError("corpus scan: a lane's audio gave mostly NaN")
    err = float(np.abs(got - plain_out)[~nan].max())
    kernel = event_ms(lambda: fused.fused_flat_batch_offline_outputs(spec, params, xs, folded=folded))
    plain = event_ms(lambda: fused.fused_batch_outputs_reference(spec, folded, xs))
    least = fused_bound(spec, xs.shape[0], xs.shape[1], 4, 1)
    print(
        f"phase 11 times [{card_line}]: the batched scan's steps ({len(streams)} lanes, "
        f"{lines} lines), host clock: {', '.join(split)} (read = WAV files, resample = "
        f"copy in, kernel and copy out per channel, scan = padding to the bucket, copy in, "
        f"batched kernel and copy out, csv = the per-row thresholds and formatting)",
        flush=True,
    )
    print(
        f"phase 11 batched kernel [{card_line}]: the scan's [{xs.shape[0]}, {xs.shape[1]}] "
        f"lanes ({xs.shape[0]} x {n_evals} evals, NaN {int(nan.sum())} from silence and "
        f"padding): "
        f"vs plain max_abs {err:.3g} (rtol=1e-4, atol=1e-5) ok; median of 21 x 10 calls: "
        f"kernel {kernel[0]:.4f} ms device ({kernel[1]:.4f} ms host enqueue), plain "
        f"{plain[0]:.4f} ms device ({plain[1]:.4f} ms host enqueue); bound {least[0]:.4f} ms "
        f"({least[1]}); tile: {tile_of(spec, xs.shape[0], xs.shape[1])}",
        flush=True,
    )
    return results, (kernel[0], plain[0], least, err), xs


def perturbed(params: dict, lane: int) -> dict:
    """``params`` with every layer's weights and biases scaled by
    ``1 + 0.03 * lane``: a distinct net per lane for any configuration."""
    scale = 1.0 + 0.03 * lane
    return {**params, "layers": [{k: v * scale for k, v in layer.items()}
                                 for layer in params["layers"]]}


def held(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> float:
    """``got`` against ``want``: the same shape, both on the card, NaN in the
    same places, the rest within the tolerance; returns the largest
    absolute difference."""
    if not (got.is_cuda and want.is_cuda):
        raise AssertionError(f"{what}: a tensor left the card")
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or not g.size:
        raise AssertionError(f"{what}: shapes {g.shape} {w.shape}")
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
    finite = np.isfinite(w)
    return float(np.abs(g[finite] - w[finite]).max()) if finite.any() else 0.0


def phase_tiers() -> dict:
    """Phase 12; returns the largest absolute difference against the plain
    version per tier, for the frames input and for the grid layout."""
    worst = {key: 0.0 for key in (*fused.TIERS, "frames", "grid")}
    for name, cfg, x, rtol, atol in fixtures.fused_cases(10.0):
        spec, params = detector.detector_spec_from_config(cfg, "cuda")
        folded = fused.fold_constants(spec, params, "cuda")
        xd = torch.from_numpy(x).cuda()
        lanes = [perturbed(params, lane) for lane in range(3)]
        stacked = fused.fold_constants_stacked(spec, lanes, "cuda")
        xs = torch.stack([torch.roll(xd, 97 * lane) for lane in range(3)])
        fp32 = fused.fused_offline_outputs(spec, params, xd, folded=folded)
        fp32_lanes = fused.fused_batch_offline_outputs(spec, lanes, xs, folded=stacked)
        report = []
        for tier, kw in TIER_KW.items():
            t_rtol, t_atol = TIER_TOL[tier]
            # one bf16 pass against fp32 under log or dB scaling: the rounding
            # of small magnitudes is amplified
            wide = (5e-2, 5e-2) if tier == "fast" and spec.scaling != "linear" else TIER_TOL[tier]
            before = (fused.TIER_LAUNCHES[tier], fused.GRID_LAUNCHES)
            got = fused.fused_offline_outputs(spec, params, xd, folded=folded, **kw)
            got_lanes = fused.fused_batch_offline_outputs(spec, lanes, xs, folded=stacked, **kw)
            torch.cuda.synchronize()
            if (fused.TIER_LAUNCHES[tier], fused.GRID_LAUNCHES) != (before[0] + 2, before[1] + 1):
                raise AssertionError(f"{name} {tier}: the tier kernel was not launched")
            plain = fused.fused_tier_outputs_reference(spec, folded, xd[None], tier)[0]
            plain_lanes = fused.fused_tier_outputs_reference(spec, stacked, xs, tier)
            err = max(held(got, plain, t_rtol, t_atol, f"{name} {tier}"),
                      held(got_lanes, plain_lanes, t_rtol, t_atol, f"{name} {tier} per-lane"))
            off = max(held(got, fp32, *wide, f"{name} {tier} vs fp32"),
                      held(got_lanes, fp32_lanes, *wide, f"{name} {tier} per-lane vs fp32"))
            worst[tier] = max(worst[tier], err)
            report.append(f"{tier} {err:.3g} (vs fp32 {off:.3g})")
        f = num_frames(len(x), spec.window_length, spec.window_overlap)
        frames = frame_signal(xd, f, spec.window_length, spec.window_overlap)
        frames_report = []
        for tier in (None, *fused.TIERS):
            kw = TIER_KW[tier] if tier else {}
            before = fused.FRAMES_LAUNCHES
            got = fused.fused_offline_outputs(spec, params, xd, folded=folded,
                                              input_mode="frames", **kw)
            torch.cuda.synchronize()
            if fused.FRAMES_LAUNCHES != before + 1:
                raise AssertionError(f"{name}: the frames-input kernel was not launched")
            f_rtol, f_atol = TIER_TOL[tier] if tier else (rtol, atol)
            err = held(got, fused.fused_frames_outputs_reference(spec, folded, frames, tier),
                       f_rtol, f_atol, f"{name} frames {tier}")
            raw = fp32 if tier is None else fused.fused_offline_outputs(
                spec, params, xd, folded=folded, **kw)
            held(got, raw, 0.0, 0.0, f"{name} frames vs raw input, {tier or 'fp32'}")
            if tier is None:
                worst["frames"] = max(worst["frames"], err)
            frames_report.append(f"{tier or 'fp32'} {err:.3g}")
        print(
            f"phase 12 tiers {name}: evals {len(fp32)}, one stream and 3 per-lane nets, vs plain "
            f"max_abs: {', '.join(report)}; frames input vs plain max_abs: "
            f"{', '.join(frames_report)} (fp32 rtol={rtol}, atol={atol}; tiers as above), equal "
            f"to raw input bit for bit under each ok",
            flush=True,
        )
    # the slabbed grid: 160 lanes in slabs of 64 (64 + 64 + 32)
    lanes = 160
    pairs = [detector.detector_spec_from_config(fixtures.sample_geometry_config(2000 + i), "cuda")
             for i in range(lanes)]
    spec = pairs[0][0]
    audio = torch.from_numpy(fixtures.chirp_audio(2.0, 51)).cuda()
    xs = torch.stack([torch.roll(audio, 131 * lane) for lane in range(lanes)])
    for nets, params in (("shared", pairs[0][1]), ("per-lane", [p for _, p in pairs])):
        folded = (fused.fold_constants_stacked(spec, params, "cuda") if nets == "per-lane"
                  else fused.fold_constants(spec, params, "cuda"))
        before = fused.GRID_LAUNCHES
        got = fused.fused_batch_offline_outputs(
            spec, params, xs, layout="grid", slab_channels=64, folded=folded)
        torch.cuda.synchronize()
        if fused.GRID_LAUNCHES != before + 3:
            raise AssertionError(f"grid {nets}: {fused.GRID_LAUNCHES - before} slab launches, not 3")
        flat = fused.fused_batch_offline_outputs(spec, params, xs, folded=folded)
        vs_flat = held(got, flat, 0.0, 1e-6, f"grid {nets} vs flat")
        err = held(got, fused.fused_batch_outputs_reference(spec, folded, xs), 1e-3, 2e-4,
                   f"grid {nets}")
        worst["grid"] = max(worst["grid"], err)
        print(
            f"phase 12 slabs {nets} nets: [{lanes}, {xs.shape[1]}] in 3 slabs of 64 lanes "
            f"({got.shape[1]} evals per lane): vs the flat kernel max_abs {vs_flat:.3g} "
            f"(atol=1e-6), vs plain {err:.3g} (rtol=1e-3, atol=2e-4) ok",
            flush=True,
        )
    return worst


def same_csv(got: list[str], want: list[str], what: str) -> float:
    """Line for line: columns 1-3 identical and outputs within 4e-7."""
    worst = compare_csv(got, want)
    if worst > 4e-7:
        raise AssertionError(f"{what}: outputs differ by {worst}")
    return worst


def scan_lines(scan: dict, mesh) -> tuple[list[str], float]:
    """(CSV lines, host seconds) of ``corpus.scan_corpus_files`` over the
    corpus with the fused method, on ``mesh`` (None: unsharded)."""
    lines: list[str] = []
    t0 = time.perf_counter()
    corpus.scan_corpus_files(
        load_config(scan["net"]), scan["files"], emit=lines.append, err=lambda s: None,
        method="fused", mesh=mesh, device="cuda",
    )
    torch.cuda.synchronize()
    return lines, time.perf_counter() - t0


def same_device(home: int, what: str) -> None:
    """Raise unless ``cuda:home`` is still the current card after ``what``."""
    now = torch.cuda.current_device()
    if now != home:
        raise AssertionError(f"{what} left cuda:{now} current, not cuda:{home}")


def long_stream() -> np.ndarray:
    """The 10-minute mono stream of the time-sharded form: the 60 s chirp
    fixture, each minute with its own seed."""
    return np.concatenate([fixtures.chirp_audio(60.0, 700 + i) for i in range(int(LONG_SECONDS // 60))])


def phase_mesh(tmp: str, scan: dict, scan_xs: torch.Tensor, card_line: str) -> dict:
    """Phase 13: the sharded paths, every count from 0; returns the launch
    counts of the run."""
    mesh = pmesh.make_mesh(n_shards=MESH_SHARDS)
    cards = {torch.device("cuda", i) for i in range(torch.cuda.device_count())}
    if set(mesh.devices) != cards:
        raise AssertionError(f"the mesh does not span the {len(cards)} card(s): {mesh}")
    home = torch.cuda.current_device()
    reset_counts()

    # the corpus through cli --mesh (one shard per card) and a 4-shard mesh
    cli_lines, wall, err = run_cli(scan["one"] + ["--batched", "--mesh", "--method", "fused"])
    if f"Mesh: {torch.cuda.device_count()} shard(s) on cuda:0" not in err:
        raise AssertionError(f"cli --mesh did not say what it sharded over: {err[-500:]}")
    worst = same_csv(cli_lines, scan["batched"], "cli --mesh")
    after_cli = fused.BATCH_LAUNCHES
    mesh_lines, mesh_wall = scan_lines(scan, mesh)
    worst = max(worst, same_csv(mesh_lines, scan["batched"], "4-shard mesh scan"))
    same_device(home, "the sharded corpus scan")
    if after_cli < 1 or fused.BATCH_LAUNCHES != after_cli + MESH_SHARDS:
        raise AssertionError(
            f"batched kernel launches: {after_cli} for cli --mesh, "
            f"{fused.BATCH_LAUNCHES - after_cli} for {MESH_SHARDS} shards")
    print(
        f"phase 13 mesh main path: cli --batched --mesh --method fused ({wall:.2f} s) and "
        f"scan_corpus_files on {mesh} ({mesh_wall:.2f} s, {MESH_SHARDS} shards of "
        f"{scan_xs.shape[0] // MESH_SHARDS} lanes): {len(mesh_lines)} CSV lines equal to the "
        f"unsharded scan's line for line, outputs max diff {worst:.3g}; batched kernel "
        f"launches {after_cli} + {MESH_SHARDS} ok",
        flush=True,
    )

    # the scan's lanes with per-lane nets through the sharded grid layout,
    # and under each tier through the slabbed grid
    cfgs = [load_config(n) for n in scan["nets"]]
    pairs = [detector.detector_spec_from_config(c, "cuda") for c in cfgs]
    spec = pairs[0][0]
    lanes = scan_xs.shape[0]
    plist = [pairs[lane % len(pairs)][1] for lane in range(lanes)]
    flat = fused.fused_batch_offline_outputs(spec, plist, scan_xs)
    launches = fused.GRID_LAUNCHES
    got = pmesh.sharded_fused_offline_outputs(mesh, spec, plist, scan_xs, layout="grid",
                                              slab_channels=2)
    slabs = fused.GRID_LAUNCHES - launches
    if slabs != MESH_SHARDS * 2:
        raise AssertionError(f"sharded grid: {slabs} slab launches, not {MESH_SHARDS * 2}")
    grid_err = held(got, flat, 0.0, 1e-6, "sharded grid vs flat")
    same_device(home, "the sharded grid layout")
    report = []
    for tier, kw in TIER_KW.items():
        tiered = fused.fused_batch_offline_outputs(spec, plist, scan_xs, **kw)
        report.append(f"{tier} {held(tiered, flat, *TIER_TOL[tier], f'corpus lanes {tier}'):.3g}")
    if min(fused.TIER_LAUNCHES.values()) < 1:
        raise AssertionError(f"tier launches {fused.TIER_LAUNCHES}")
    print(
        f"phase 13 mesh: the scan's [{lanes}, {scan_xs.shape[1]}] lanes, per-lane nets, "
        f"sharded_fused_offline_outputs(layout='grid', slab_channels=2) on {MESH_SHARDS} shards "
        f"({slabs} slab launches) vs the unsharded flat kernel max_abs {grid_err:.3g} "
        f"(atol=1e-6); each tier through the slabbed grid vs fp32 max_abs: {', '.join(report)} ok",
        flush=True,
    )

    # one 10-minute stream, its time axis over 4 shards
    params = pairs[0][1]
    x = torch.from_numpy(long_stream()).cuda()
    whole = detector.offline_outputs(spec, params, x)
    time_mesh = pmesh.make_mesh(n_shards=MESH_SHARDS, axis="time")
    launches = fused.LAUNCHES
    report = []
    for method, (rtol, atol) in (("matmul", (1e-4, 1e-5)), ("fused", (1e-3, 2e-4))):
        got = pmesh.time_sharded_offline_outputs(time_mesh, spec, params, x, method=method)
        report.append(f"{method} {held(got, whole, rtol, atol, f'time-sharded {method}'):.3g}")
        same_device(home, f"the time-sharded {method} form")
    if fused.LAUNCHES != launches + MESH_SHARDS:
        raise AssertionError(f"time-sharded fused: {fused.LAUNCHES - launches} launches")
    by_frames = fused.fused_offline_outputs(spec, params, x, input_mode="frames")
    frames_err = held(got, by_frames, *CROSS_KERNEL_TOL, "time-sharded fused vs frames input")
    if fused.FRAMES_LAUNCHES != 1:
        raise AssertionError(f"frames-input launches {fused.FRAMES_LAUNCHES}")
    print(
        f"phase 13 mesh: time_sharded_offline_outputs on {len(x)} samples ({len(whole)} evals, "
        f"{x.numel() * 4 / 1e6:.0f} MB) over {MESH_SHARDS} shards vs offline_outputs on the whole "
        f"stream, max_abs: {', '.join(report)} (rtol=1e-4, atol=1e-5; fused 1e-3, 2e-4); fused vs "
        f"the frames-input kernel on the whole stream {frames_err:.3g} (rtol={CROSS_KERNEL_TOL[0]}, "
        f"atol={CROSS_KERNEL_TOL[1]}) ok",
        flush=True,
    )

    # the feature axis over 4 shards: 29 bins -> 8 per shard, zero-padded
    x60 = x[: int(CORPUS_SECONDS * NET_RATE)]
    report = []
    for scaling, (rtol, atol) in (("linear", (1e-3, 2e-4)), ("log", (2e-3, 5e-4)),
                                  ("db", (2e-3, 5e-4))):
        s_spec, s_params = detector.detector_spec_from_config(
            fixtures.sample_geometry_config(0, scaling=scaling), "cuda")
        got = pmesh.tensor_sharded_offline_outputs(mesh, s_spec, s_params, x60)
        want = detector.offline_outputs(s_spec, s_params, x60)
        report.append(f"{scaling} {held(got, want, rtol, atol, f'tensor-sharded {scaling}'):.3g}")
        same_device(home, f"the tensor-sharded form ({scaling})")
    print(
        f"phase 13 mesh: tensor_sharded_offline_outputs over {MESH_SHARDS} shards on a "
        f"{CORPUS_SECONDS:g} s stream vs offline_outputs, max_abs: {', '.join(report)} "
        f"(rtol=1e-3, atol=2e-4; log and dB 2e-3, 5e-4) ok",
        flush=True,
    )

    # detection counts and streaming steps over the 16 lanes' first 10 s;
    # the counts with the first net on every lane, whose threshold lies away
    # from every output on this audio
    xs = scan_xs[:, : 10 * NET_RATE].contiguous()
    shared = neural_net.stack_params([params] * lanes)
    counts = pmesh.sharded_detection_counts(mesh, spec, shared, xs)
    same_device(home, "sharded_detection_counts")
    outs = pmesh.batch_offline_outputs(spec, shared, xs)
    want = int((outs >= torch.tensor(spec.thresholds, device="cuda")).sum())
    if not counts.is_cuda or counts.dtype != torch.int32 or int(counts[0]) != want or want <= 0:
        raise AssertionError(f"sharded_detection_counts {counts.tolist()} against {want}")
    hops, steps = 16, 8
    r = spec.residual
    stacked = neural_net.stack_params(plist)
    carries = neural_net.stack_params([detector.streaming_init(spec, lane[:r]) for lane in xs])
    rows = []
    for step in range(steps):
        lo = r + step * hops * spec.hop
        carries, out = pmesh.sharded_streaming_step(
            mesh, spec, stacked, carries, xs[:, lo : lo + hops * spec.hop].contiguous())
        rows.append(out)
    got = torch.cat(rows, dim=1)[:, spec.history :]
    used = r + steps * hops * spec.hop
    want_rows = torch.stack([
        detector.streaming_scan(spec, plist[lane], xs[lane, :used])[: got.shape[1]]
        for lane in range(lanes)
    ])
    step_err = held(got, want_rows, 1e-4, 1e-5, "sharded_streaming_step")
    same_device(home, "sharded_streaming_step")
    print(
        f"phase 13 mesh: sharded_detection_counts {counts.tolist()} equal to the count of the "
        f"unsharded outputs; sharded_streaming_step, {lanes} lanes x {steps} steps of {hops} "
        f"hops, vs streaming_scan max_abs {step_err:.3g} (rtol=1e-4, atol=1e-5); the mesh spans "
        f"{len(cards)} card(s), cuda:{home} current after every form ok",
        flush=True,
    )
    return {"frames": fused.FRAMES_LAUNCHES, "tiers": dict(fused.TIER_LAUNCHES),
            "grid": fused.GRID_LAUNCHES, "batch": fused.BATCH_LAUNCHES, "one": fused.LAUNCHES}


def phase_dist_scan(tmp: str, scan: dict) -> float:
    """Phase 14: two dist_scan processes on the card; returns their wall
    seconds."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = os.path.join(tmp, "dist")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    argv = ["-n", scan["net"]] + [a for f in scan["files"] for a in ("-a", f)]
    t0 = time.perf_counter()
    ranks = [
        subprocess.Popen(
            [sys.executable, "-m", "syllable_detector_tpu_torch.dist_scan",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(rank), "--device", "cuda", "--method", "fused",
             "-o", out_dir, *argv],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(2)
    ]
    try:
        logs = [proc.communicate(timeout=300)[1] for proc in ranks]
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    totals = []
    for rank, (proc, log) in enumerate(zip(ranks, logs)):
        m = re.search(rf"process {rank}/2: (\d+) files, (\d+) detections \(global (\d+)\)", log)
        if proc.returncode != 0 or not m:
            raise AssertionError(f"dist_scan rank {rank}: exit {proc.returncode}: {log[-2000:]}")
        totals.append(tuple(int(v) for v in m.groups()))
    with open(os.path.join(out_dir, "merged.csv")) as fh:
        merged = fh.read().splitlines()
    worst = same_csv(merged, scan["batched"], "dist_scan merged.csv")
    detections = len(merged) - len(scan["files"])
    if [t[0] for t in totals] != [4, 4] or not (
            totals[0][2] == totals[1][2] == totals[0][1] + totals[1][1] == detections):
        raise AssertionError(f"dist_scan counts {totals} for {detections} detection lines")
    print(
        f"phase 14 dist_scan: 2 processes on cuda:0 (gloo over 127.0.0.1), {len(scan['files'])} "
        f"files split 4 + 4, {wall:.2f} s: merged.csv equal to the single-process CSV line for "
        f"line ({len(merged)} lines, outputs max diff {worst:.3g}); detections "
        f"{totals[0][1]} + {totals[1][1]}, both ranks report global {totals[0][2]} ok",
        flush=True,
    )
    return wall


def phase_new_times(scan: dict, scan_xs: torch.Tensor, scan_k1e, dist_wall: float,
                    card_line: str) -> dict:
    """Phase 15; returns (kernel ms, plain ms, bound) per tier, for the
    frames input (60 s stream) and for the grid layout (the scan's lanes)."""
    cfg = fixtures.sample_geometry_config(0)
    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    folded = fused.fold_constants(spec, params, "cuda")
    xd = torch.from_numpy(fixtures.chirp_audio(60.0, 21)).cuda()
    n = xd.numel()
    times = {}
    k1a = event_ms(lambda: fused.fused_offline_outputs(spec, params, xd, folded=folded))[0]
    for tier, kw in TIER_KW.items():
        kernel = event_ms(lambda: fused.fused_offline_outputs(spec, params, xd, folded=folded, **kw))
        plain = event_ms(lambda: fused.fused_tier_outputs_reference(spec, folded, xd[None], tier))
        times[tier] = (kernel[0], plain[0], fused_bound(spec, 1, n, 4, 1, tier=tier))
    f = num_frames(n, spec.window_length, spec.window_overlap)
    frames = frame_signal(xd, f, spec.window_length, spec.window_overlap).contiguous()
    kernel = event_ms(lambda: fused.fused_offline_outputs(
        spec, params, xd, folded=folded, input_mode="frames"))
    plain = event_ms(lambda: fused.fused_frames_outputs_reference(spec, folded, frames))
    times["frames"] = (kernel[0], plain[0], fused_bound(spec, 1, n, 4, 1, frames_input=True))
    # the frames input's two parts: the gather, and the kernel on its result
    gather_ms = event_ms(lambda: frame_signal(
        xd, f, spec.window_length, spec.window_overlap).contiguous())[0]
    gathered = frames[None]
    alone_ms = event_ms(lambda: fused._launch(
        spec, folded, gathered, f - spec.time_range + 1, frames_input=True))[0]
    for name, (k, p, least) in times.items():
        tier = None if name == "frames" else name
        print(
            f"phase 15 times [{card_line}]: {name} on the 60 s stream ({n} samples), median of "
            f"21 x 10 calls: kernel {k:.4f} ms device ({tile_of(spec, 1, n, tier, name == 'frames')}; "
            f"before: {EARLIER_MS[name][0]} ms), plain {p:.4f} ms device, the fp32 kernel "
            f"{k1a:.4f} ms ({tile_of(spec, 1, n)}); bound {least[0]:.4f} ms ({least[1]})"
            + (f" (the kernel's time includes gathering the frames: the gather alone "
               f"{gather_ms:.4f} ms, the kernel alone on the gathered frames {alone_ms:.4f} ms)"
               if name == "frames" else ""),
            flush=True,
        )
    # the grid layout and the tiers on the corpus scan's lanes, beside the
    # flat kernel (timed in phase 11 and again here, in turns)
    net_spec, net_params = detector.detector_spec_from_config(load_config(scan["net"]), "cuda")
    net_folded = fused.fold_constants(net_spec, net_params, "cuda")
    lanes, width = scan_xs.shape

    def run(**kw):
        return event_ms(lambda: fused.fused_batch_offline_outputs(
            net_spec, net_params, scan_xs, folded=net_folded, **kw), samples=11, batch=5)[0]

    flat = [run()]
    grid = [run(layout="grid"), run(layout="grid")]
    flat.append(run())
    tiers = {tier: run(**kw) for tier, kw in TIER_KW.items()}
    times["grid"] = (statistics.median(grid), scan_k1e[1], scan_k1e[2])
    tier_bounds = {tier: fused_bound(net_spec, lanes, width, 4, 1, tier=tier) for tier in TIER_KW}
    tier_report = ", ".join(
        f"{t} {ms:.4f} ms (before: {EARLIER_MS[t][1]} ms; bound {tier_bounds[t][0]:.4f} ms, "
        f"{tier_bounds[t][1]})" for t, ms in tiers.items())
    print(
        f"phase 15 times [{card_line}]: the scan's [{lanes}, {width}] lanes, median of 11 x 5 "
        f"calls, in turns: flat kernel {flat[0]:.4f} / {flat[1]:.4f} ms, grid layout (one slab "
        f"of {lanes} lanes) {grid[0]:.4f} / {grid[1]:.4f} ms; tiers through the grid: "
        f"{tier_report}; the fp32 kernel's bound {scan_k1e[2][0]:.4f} ms ({scan_k1e[2][1]}), "
        f"its tile: {tile_of(net_spec, lanes, width)}",
        flush=True,
    )
    # where the kernel's CTAs spend their cycles (clock64 per stage), in
    # full fp32 and under the split tier
    n_round = bucket_samples(spec, 128)
    round_xs = scan_xs[:1, :n_round].expand(LANES, n_round).contiguous()
    shapes = (
        ("fp32", "the 60 s stream", lambda: fused.fused_offline_outputs(
            spec, params, xd, folded=folded)),
        ("fp32", f"a {LANES} x 128 round", lambda: fused.fused_flat_batch_offline_outputs(
            spec, params, round_xs, folded=folded)),
        ("fp32", f"the scan's [{lanes}, {width}] lanes", lambda: fused.fused_batch_offline_outputs(
            net_spec, net_params, scan_xs, folded=net_folded)),
        ("split", "the 60 s stream", lambda: fused.fused_offline_outputs(
            spec, params, xd, folded=folded, split=True)),
        ("split", f"the scan's [{lanes}, {width}] lanes", lambda: fused.fused_batch_offline_outputs(
            net_spec, net_params, scan_xs, folded=net_folded, split=True)),
    )
    for tier, name, launch in shapes:
        launch()
        shares = fused.stage_shares(launch)
        print(
            f"phase 15 stages [{card_line}]: the kernel ({tier}) on {name}, share of the CTAs' "
            f"cycles: {', '.join(f'{stage} {share:.3f}' for stage, share in shares.items())}",
            flush=True,
        )
    # host walls: the sharded scan beside the unsharded one, in turns
    mesh = pmesh.make_mesh(n_shards=MESH_SHARDS)
    walls = {"unsharded": [], "mesh": []}
    for mode in ("unsharded", "mesh", "mesh", "unsharded"):
        walls[mode].append(scan_lines(scan, mesh if mode == "mesh" else None)[1])
    x = torch.from_numpy(long_stream()).cuda()
    time_mesh = pmesh.make_mesh(n_shards=MESH_SHARDS, axis="time")
    long_walls = {"whole": [], "sharded": []}
    for mode in ("whole", "sharded", "sharded", "whole") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "whole":
            fused.fused_offline_outputs(spec, params, x, folded=folded)
        else:
            pmesh.time_sharded_offline_outputs(time_mesh, spec, params, x, method="fused")
        torch.cuda.synchronize()
        long_walls[mode].append((time.perf_counter() - t0) * 1e3)
    print(
        f"phase 15 times [{card_line}]: host clock, in turns: scan_corpus_files unsharded "
        f"{', '.join(f'{s:.3f}' for s in walls['unsharded'])} s, on {MESH_SHARDS} shards of one "
        f"card {', '.join(f'{s:.3f}' for s in walls['mesh'])} s; the {LONG_SECONDS:g} s stream "
        f"through the fused kernel whole {statistics.median(long_walls['whole']):.3f} ms, "
        f"time-sharded over {MESH_SHARDS} shards {statistics.median(long_walls['sharded']):.3f} ms "
        f"(medians of 6, to completion); the two-process dist_scan {dist_wall:.2f} s",
        flush=True,
    )
    return times


def labeled_files(tmp: str, name: str, seed: int) -> tuple[np.ndarray, list, str, str]:
    """A labeled TRAIN_SECONDS WAV and its interval CSV: (audio, intervals,
    WAV path, CSV path)."""
    audio, intervals = make_labeled_audio(TRAIN_SECONDS, rate=NET_RATE, seed=seed)
    wav, csv = os.path.join(tmp, f"{name}.wav"), os.path.join(tmp, f"{name}.csv")
    write_wav(wav, audio, NET_RATE, dtype="float32")
    with open(csv, "w") as fh:
        fh.write("# start,end\n" + "".join(f"{lo},{hi}\n" for lo, hi in intervals))
    return audio, intervals, wav, csv


class TrainSpy:
    """Inside ``with``: records, for each run of the trainer's epoch loop,
    the devices of its data, parameters and optimizer state before and after
    the epochs, the optimizer steps it ran, its wall to the last step's
    completion, the epoch function with the arguments of its first call
    (the run's initial state and first index rows) and the Adam counts it
    ended with; and every config the train CLI exported."""

    def __enter__(self):
        self.runs, self.exported = [], []
        self._loop, self._export = trainer._run_training_loop, train_cli.export_trained_config

        def loop(settings, epoch_fn, data, epoch_indices, params, opt_state, *rest):
            run = {"before": {t.device.type for t in pmesh._leaves((data, params, opt_state))},
                   "steps": 0, "epochs": settings.epochs}

            def counted(*args):
                run.setdefault("first", (epoch_fn, args))
                run["steps"] += args[-1].shape[0]
                return epoch_fn(*args)

            t0 = time.perf_counter()
            params, opt_state = self._loop(settings, counted, data, epoch_indices, params,
                                           opt_state, *rest)
            torch.cuda.synchronize()
            run["wall"] = time.perf_counter() - t0
            run["after"] = {t.device.type for t in pmesh._leaves((params, opt_state))}
            run["count"] = set(opt_state[0].tolist())
            self.runs.append(run)
            return params, opt_state

        def export(*args):
            self.exported.append(self._export(*args))
            return self.exported[-1]

        trainer._run_training_loop, train_cli.export_trained_config = loop, export
        return self

    def __exit__(self, *exc):
        trainer._run_training_loop, train_cli.export_trained_config = self._loop, self._export


def run_train(argv: list[str]) -> float:
    """Host seconds of one ``train.main`` run, which must return 0."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"train.main({argv}) returned {rc}: {err.getvalue()[-2000:]}")
    return time.perf_counter() - t0


def hit_rate(lines: list[str], intervals) -> float:
    """Share of detection lines within 0.1 s of a labeled interval."""
    rows = [line for line in lines if line.count(",") >= 3]
    hits = sum(any(lo - 0.1 <= float(r.split(",")[2]) <= hi + 0.1 for lo, hi in intervals)
               for r in rows)
    return hits / max(1, len(rows))


def held_trees(got, want, rtol: float, atol: float, what: str) -> float:
    """Every tensor of ``got`` against ``want``'s; returns the largest
    absolute difference."""
    worst = 0.0
    for g, w in zip(pmesh._leaves(got), pmesh._leaves(want), strict=True):
        g, w = g.detach().cpu().numpy(), w.detach().cpu().numpy()
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
        worst = max(worst, float(np.abs(g - w).max()))
    return worst


def bit_equal(got, want, what: str) -> None:
    for g, w in zip(pmesh._leaves(got), pmesh._leaves(want), strict=True):
        if not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{what}: not bit for bit equal")


def same_bits(got, want) -> bool:
    return all(
        g.shape == w.shape and g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
        for g, w in zip(pmesh._leaves(got), pmesh._leaves(want), strict=True))


def graph_against_plain(got, want, what: str) -> str:
    """The epoch graph's result against the plain per-step loop's: "bit for
    bit", or else every tensor held at GRAPH_TOL and the largest
    difference named."""
    if same_bits(got, want):
        return "bit for bit"
    worst = held_trees(got, want, *GRAPH_TOL, what)
    return f"not bit for bit, max abs {worst:.3g} (rtol={GRAPH_TOL[0]:g}, atol={GRAPH_TOL[1]:g})"


def graph_route(run: dict, what: str) -> str:
    """The checks of a main-path training run on the card: the epoch graph
    captured and replayed once an epoch trained, the Adam count of every
    net equal to the optimizer steps, and the run's initial state, held by
    the spy, not advanced by the run."""
    graphs = dict(trainer.EPOCH_GRAPHS)
    if graphs["captures"] < 1 or graphs["replays"] != run["epochs"]:
        raise AssertionError(f"{what}: epoch graphs {graphs} for {run['epochs']} epochs")
    if run["count"] != {run["steps"]}:
        raise AssertionError(f"{what}: Adam counts {run['count']} for {run['steps']} steps")
    if set(run["first"][1][1][0].tolist()) != {0}:
        raise AssertionError(f"{what}: the epoch advanced its caller's state")
    return (f"epoch graphs {graphs['captures']} captured, {graphs['replays']} replays for "
            f"{run['epochs']} epochs, Adam count {run['steps']} on every net")


def graph_check(run: dict, epochs: int, what: str) -> tuple[str, str]:
    """A main-path run's epoch function, from the state of its first call,
    over its first ``epochs`` epochs: the graph against the plain per-step
    loop (``epoch.plain``), and a second graph call bit for bit the first.
    Returns (the comparison, the graph's pool in MiB)."""
    epoch_fn, (params, opt_state, feats, labels, idx) = run["first"]
    rows = idx[: epochs * epoch_fn.steps]
    got = epoch_fn(params, opt_state, feats, labels, rows)
    bit_equal(epoch_fn(params, opt_state, feats, labels, rows), got, f"{what}: a second call")
    verdict = graph_against_plain(got, epoch_fn.plain(params, opt_state, feats, labels, rows), what)
    pools = [g.pool_bytes / 2**20 for g in epoch_fn.graphs.values()]
    return verdict, "/".join(f"{p:.1f}" for p in pools)


def phase_train(tmp: str) -> dict:
    """Phase 16, the training slice's main path; returns what phase 17
    times."""
    t_phase = time.perf_counter()
    audio, intervals, wav, csv = labeled_files(tmp, "train", 31)
    net = os.path.join(tmp, "trained.txt")
    # (a) the train CLI at its defaults on the card
    reset_counts()
    with TrainSpy() as spy:
        cli_wall = run_train(["-a", wav, "-l", csv, "-o", net, "--device", "cuda", "--quiet"])
    run = spy.runs[0]
    if len(spy.runs) != 1 or run["before"] != {"cuda"} or run["after"] != {"cuda"}:
        raise AssertionError(f"the trainer's features, params and Adam state were on {spy.runs}")
    loaded = load_config(net)
    exported = spy.exported[0]
    if dumps_config(loaded) != dumps_config(exported) or not all(
            np.array_equal(a.weights, b.weights) and np.array_equal(a.biases, b.biases)
            for a, b in zip(loaded.layers, exported.layers, strict=True)):
        raise AssertionError("the net file does not load back to the exported config")
    settings = trainer.TrainSettings(epochs=300, batch_size=256, learning_rate=3e-3, seed=0)
    feats, labels = trainer.features_and_labels(settings, audio, intervals, device="cpu")
    steps = settings.epochs * (len(feats) // settings.batch_size)
    if run["steps"] != steps:
        raise AssertionError(f"{run['steps']} optimizer steps for {steps}")
    cli_graphs = graph_route(run, "the train CLI")
    print(
        f"phase 16 train main path: train.main at the CLI defaults (300 epochs, batch 256, lr "
        f"3e-3, 4 inits) on a {TRAIN_SECONDS:g} s labeled file ({len(feats)} evaluations, "
        f"{int(labels.sum())} positive, {feats.nbytes} B of features): rc 0 in {cli_wall:.2f} s, "
        f"{run['steps']} optimizer steps; {cli_graphs}; features, params and Adam state on "
        f"{'/'.join(sorted(run['before']))} before and after the epochs; the net file loads "
        f"back to the exported config (threshold {exported.thresholds[0]:.4f}) ok",
        flush=True,
    )

    # (b) the trained net through the fused kernel (K1a) and the matmul path
    argv = ["-n", net, "-a", wav, "--device", "cuda"]
    reset_counts()
    fused_csv = run_cli(argv + ["--method", "fused"])[0]
    k1a = fused.LAUNCHES
    matmul_csv = run_cli(argv + ["--method", "matmul"])[0]
    worst = compare_csv(fused_csv, matmul_csv)
    hits = hit_rate(fused_csv, intervals)
    if k1a <= 0 or not fused_csv or hits <= 0.8:
        raise AssertionError(f"trained net: K1a launches {k1a}, {len(fused_csv)} lines, hits {hits}")
    print(
        f"phase 16 train: the trained net through cli --method fused vs matmul: "
        f"{len(fused_csv)} detection lines, columns 1-3 identical, outputs max diff "
        f"{worst:.3g}; {hits:.3f} of them within 0.1 s of a labeled interval; fused kernel "
        f"launches {k1a} ok",
        flush=True,
    )

    # (c) features on the card against the CPU
    dev_feats, dev_labels = trainer.features_and_labels(settings, audio, intervals, device="cuda")
    np.testing.assert_allclose(dev_feats, feats, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(dev_labels, labels)
    feat_err = float(np.abs(dev_feats - feats).max())

    # (d) one epoch of K stacked inits from the same draws, card against CPU
    net_spec = trainer._build_net_spec(settings)
    in_specs, _ = trainer.fit_input_chain(settings, feats, "cpu")
    sizes = [settings.n_features, *settings.hidden, 1]
    n_steps = len(feats) // settings.batch_size
    idx = np.random.default_rng(settings.seed).permutation(len(feats))[
        : n_steps * settings.batch_size].reshape(n_steps, settings.batch_size).astype(np.int32)
    epoch_fn = trainer._make_restart_epoch(net_spec, settings.learning_rate)
    start, after = {}, {}
    for device in ("cuda", "cpu"):
        generator = torch.Generator().manual_seed(settings.seed)
        params = neural_net.stack_params([
            {"layers": trainer.init_layer_params(generator, sizes, device=device),
             "process_inputs": processing.specs_to_chain(in_specs, device)[1],
             "process_outputs": processing.specs_to_chain([trainer._output_mapminmax()], device)[1]}
            for _ in range(settings.n_init)])
        start[device] = (params, trainer._adam_init(params["layers"], (settings.n_init,)),
                         torch.tensor(feats, device=device), torch.tensor(labels, device=device),
                         torch.tensor(idx, device=device))
        after[device] = epoch_fn(*start[device])
    epoch_err = held_trees(after["cuda"], after["cpu"], 1e-4, 1e-5, "one epoch, card vs CPU")
    print(
        f"phase 16 train: features_and_labels on the card vs the CPU: max abs {feat_err:.3g} "
        f"(rtol=1e-5, atol=1e-6), labels equal; one epoch ({n_steps} steps) of "
        f"_make_restart_epoch from the same {settings.n_init} inits, card vs CPU: params, Adam "
        f"state and losses max abs {epoch_err:.3g} (rtol=1e-4, atol=1e-5) ok",
        flush=True,
    )

    # (e) a 16-channel ensemble through the train CLI, its nets through the
    # batched fused kernel (K1e) on a 16-channel arrangement of the audio
    chans = [labeled_files(tmp, f"chan{c}", 100 + c) for c in range(ENSEMBLE_CHANNELS)]
    template = os.path.join(tmp, "chan_net_{ch}.txt")
    pairs = [a for _, _, w, l in chans for a in ("-a", w, "-l", l)]
    reset_counts()
    with TrainSpy() as ens_spy:
        ens_wall = run_train(pairs + ["-o", template, "--epochs", str(ENSEMBLE_EPOCHS),
                                      "--device", "cuda", "--quiet"])
    ens_run = ens_spy.runs[0]
    if ens_run["before"] != {"cuda"} or ens_run["after"] != {"cuda"}:
        raise AssertionError(f"the ensemble's state was on {ens_spy.runs}")
    ens_graphs = graph_route(ens_run, "the ensemble")
    wide = os.path.join(tmp, "sixteen.wav")
    write_wav(wide, np.stack([a for a, *_ in chans], 1), NET_RATE, dtype="float32")
    nets = [template.replace("{ch}", str(c)) for c in range(ENSEMBLE_CHANNELS)]
    argv = [a for n in nets for a in ("-n", n)] + ["-a", wide, "--batched", "--device", "cuda"]
    reset_counts()
    ens_fused = run_cli(argv + ["--method", "fused"])[0]
    k1e = fused.BATCH_LAUNCHES
    ens_matmul = run_cli(argv + ["--method", "matmul"])[0]
    ens_worst = compare_csv(ens_fused, ens_matmul)
    rates = [hit_rate([l for l in ens_fused if l.startswith(f"{c},")], chans[c][1])
             for c in range(ENSEMBLE_CHANNELS)]
    if k1e <= 0 or min(rates) <= 0.8:
        raise AssertionError(f"ensemble: K1e launches {k1e}, hit rates {rates}")
    print(
        f"phase 16 train: {ENSEMBLE_CHANNELS}-channel ensemble through train.main ({ENSEMBLE_EPOCHS} "
        f"epochs, {ens_run['steps']} steps, {ens_wall:.2f} s; {ens_graphs}), its "
        f"{ENSEMBLE_CHANNELS} nets through "
        f"cli --batched --method fused vs matmul on one {ENSEMBLE_CHANNELS}-channel file: "
        f"{len(ens_fused)} detection lines, columns 1-3 identical, outputs max diff "
        f"{ens_worst:.3g}; hits within 0.1 s per channel {min(rates):.3f}-{max(rates):.3f}; "
        f"batched kernel launches {k1e} ok",
        flush=True,
    )

    # (f) sharded against unsharded, on MESH_SHARDS shards of the one card;
    # the data mesh's epoch graph (one capture, one replay an epoch), and a
    # one-shard data mesh bit for bit unsharded training
    short = dataclasses.replace(settings, epochs=SHORT_EPOCHS)
    one_card = [torch.device("cuda", 0)]
    _, whole, t_whole = trainer.train(short, feats, labels, device="cuda")
    reset_counts()
    with TrainSpy() as dp_spy:
        _, sharded, t_sharded = trainer.train(
            short, feats, labels, mesh=pmesh.make_mesh(MESH_SHARDS, axis="data", devices=one_card))
    dp_route = graph_route(dp_spy.runs[0], "the data mesh")
    dp_err = held_trees(sharded, whole, 1e-4, 1e-5, "data-parallel vs unsharded")
    _, one, t_one = trainer.train(
        short, feats, labels, mesh=pmesh.make_mesh(1, axis="data", devices=one_card))
    bit_equal(one, whole, "the one-shard data mesh against unsharded training")
    if t_one != t_whole:
        raise AssertionError(f"the one-shard data mesh's threshold {t_one} for {t_whole}")
    # the data mesh's epoch graph against its plain per-step loop, from the
    # CLI run's initial state over GRAPH_EPOCHS epochs of its index rows
    cli_fn, (c_params, c_state, c_feats, c_labels, c_idx) = run["first"]
    c_rows = c_idx[: GRAPH_EPOCHS * cli_fn.steps]
    dp_fn = trainer._make_restart_epoch(
        net_spec, settings.learning_rate,
        mesh=pmesh.make_mesh(MESH_SHARDS, axis="data", devices=one_card), steps=cli_fn.steps)
    reset_counts()
    dp_graph = dp_fn(c_params, c_state, c_feats, c_labels, c_rows)
    dp_counts = dict(trainer.EPOCH_GRAPHS)
    if dp_counts != {"captures": 1, "replays": GRAPH_EPOCHS}:
        raise AssertionError(f"the data mesh's epoch graphs: {dp_counts}")
    bit_equal(dp_graph, dp_fn.plain(c_params, c_state, c_feats, c_labels, c_rows),
              "the data mesh's epoch graph against its plain per-step loop")
    dp_pool = "/".join(f"{g.pool_bytes / 2**20:.1f}" for g in dp_fn.graphs.values())
    ens_data = [trainer.features_and_labels(settings, a, iv, device="cuda") for a, iv, *_ in chans]
    ens_f, ens_l = [f for f, _ in ens_data], [l for _, l in ens_data]
    _, ens_whole, _ = trainer.train_ensemble(short, ens_f, ens_l, device="cuda")
    _, ens_sharded, _ = trainer.train_ensemble(
        short, ens_f, ens_l, mesh=pmesh.make_mesh(MESH_SHARDS, axis="channel"))
    cp_err = held_trees(ens_sharded, ens_whole, 1e-4, 1e-5, "channel-parallel vs unsharded")
    if not all(t.is_cuda for t in pmesh._leaves((sharded, one, dp_graph, ens_sharded))):
        raise AssertionError("the sharded results are not on the card")
    print(
        f"phase 16 train: train on a {MESH_SHARDS}-shard data mesh vs unsharded ({SHORT_EPOCHS} "
        f"epochs; {dp_route}): params max abs {dp_err:.3g}, thresholds {t_sharded:.6f} / "
        f"{t_whole:.6f}; on a one-shard data mesh params and threshold bit for bit unsharded; "
        f"the {MESH_SHARDS}-shard data mesh's epoch from the CLI run's initial state over "
        f"{GRAPH_EPOCHS} epochs ({dp_counts['captures']} capture, {dp_counts['replays']} "
        f"replays, pool {dp_pool} MiB) bit for bit its plain per-step loop; train_ensemble "
        f"({ENSEMBLE_CHANNELS} channels) on a {MESH_SHARDS}-shard channel mesh vs unsharded: "
        f"max abs {cp_err:.3g} (rtol=1e-4, atol=1e-5); results on the card ok",
        flush=True,
    )

    # the epoch graphs against the plain per-step loop, from the main-path
    # runs' initial states: the CLI's restart epoch, the 16-channel
    # ensemble's, and shard 0 of that ensemble on a 4-shard channel mesh
    # (each shard its own graph, replayed on its own stream)
    restart, restart_pool = graph_check(run, GRAPH_EPOCHS, "the restart epoch graph")
    ens_vs, ens_pool = graph_check(ens_run, GRAPH_EPOCHS, "the ensemble epoch graph")
    ens_fn, (e_params, e_state, e_feats, e_labels, e_idx) = ens_run["first"]
    e_rows = e_idx[: GRAPH_EPOCHS * ens_fn.steps]
    mesh_fn = trainer.make_ensemble_epoch(
        trainer._build_net_spec(settings), settings.learning_rate, n_init=settings.n_init,
        mesh=pmesh.make_mesh(MESH_SHARDS, axis="channel"), steps=ens_fn.steps)
    reset_counts()
    sharded_graph = mesh_fn(e_params, e_state, e_feats, e_labels, e_rows)
    shard_graphs = dict(trainer.EPOCH_GRAPHS)
    if shard_graphs != {"captures": MESH_SHARDS, "replays": MESH_SHARDS * GRAPH_EPOCHS}:
        raise AssertionError(f"the channel mesh's epoch graphs: {shard_graphs}")
    per = ENSEMBLE_CHANNELS // MESH_SHARDS
    nets = slice(0, per * settings.n_init)
    shard0 = ens_fn.plain(pmesh._tree_map(lambda t: t[nets], e_params),
                          pmesh._tree_map(lambda t: t[nets], e_state),
                          e_feats[:per], e_labels[:per], e_rows[:, :per])
    shard_vs = graph_against_plain(
        (pmesh._tree_map(lambda t: t[nets], sharded_graph[0]),
         pmesh._tree_map(lambda t: t[nets], sharded_graph[1]), sharded_graph[2][:, nets]),
        shard0, "shard 0 of the channel mesh")
    print(
        f"phase 16 train graph: the epoch graph against the plain per-step loop on the card, "
        f"from each main-path run's initial state over {GRAPH_EPOCHS} epochs (params, Adam "
        f"moments and count, losses): the CLI's restart epoch ({settings.n_init} inits, batch "
        f"{settings.batch_size}, {settings.n_features} features, {run['first'][0].steps} steps) "
        f"{restart}, graph pool {restart_pool} MiB; the {ENSEMBLE_CHANNELS}-channel ensemble "
        f"({ens_fn.steps} steps) {ens_vs}, pool {ens_pool} MiB; shard 0 of {MESH_SHARDS} on a "
        f"channel mesh ({shard_graphs['captures']} graphs, {shard_graphs['replays']} replays) "
        f"{shard_vs}; a second graph call bit for bit the first ok",
        flush=True,
    )

    # (g) interrupted after SHORT_EPOCHS - 1 epochs and resumed, against
    # uninterrupted, bit for bit: the CLI (a net file holds every float32
    # exactly) and the data mesh
    ckpt = os.path.join(tmp, "ckpt")
    base = ["-a", wav, "-l", csv, "--device", "cuda", "--quiet"]
    every = ["--checkpoint-dir", ckpt, "--checkpoint-every", "1"]
    outs = {name: os.path.join(tmp, f"{name}.txt") for name in ("full", "part", "resumed")}
    run_train(base + ["-o", outs["full"], "--epochs", str(SHORT_EPOCHS)])
    run_train(base + ["-o", outs["part"], "--epochs", str(SHORT_EPOCHS - 1)] + every)
    run_train(base + ["-o", outs["resumed"], "--epochs", str(SHORT_EPOCHS)] + every)
    with open(outs["full"]) as a, open(outs["resumed"]) as b:
        if a.read() != b.read():
            raise AssertionError("the resumed CLI run's net differs from the uninterrupted one's")
    mesh = pmesh.make_mesh(MESH_SHARDS, axis="data", devices=one_card)
    part = dataclasses.replace(settings, epochs=SHORT_EPOCHS - 1)
    mesh_ckpt = os.path.join(tmp, "mesh_ckpt")
    trainer.train(part, feats, labels, mesh=mesh, checkpoint_dir=mesh_ckpt, checkpoint_every=1)
    _, m_res, mt_res = trainer.train(short, feats, labels, mesh=mesh, checkpoint_dir=mesh_ckpt,
                                     checkpoint_every=1)
    bit_equal(m_res, sharded, "the resumed mesh run")
    if mt_res != t_sharded:
        raise AssertionError("the resumed mesh run's threshold differs")
    print(
        f"phase 16 train: train.main --checkpoint-dir interrupted after {SHORT_EPOCHS - 1} of "
        f"{SHORT_EPOCHS} epochs and resumed, vs uninterrupted: net files byte for byte equal; the "
        f"same on the {MESH_SHARDS}-shard data mesh through the API: params and threshold bit "
        f"for bit equal ok ({time.perf_counter() - t_phase:.1f} s since the phase began)",
        flush=True,
    )
    return {"epoch": (epoch_fn, *start["cuda"]), "cli_wall": cli_wall, "run": run,
            "ens_wall": ens_wall, "ens_run": ens_run, "n_evals": len(feats),
            "argv": ["-a", wav, "-l", csv, "--device", "cuda", "--quiet"], "tmp": tmp}


def busy_share(fn, steps: int) -> str:
    """The device's busy share over 3 calls of ``fn`` (3 epochs of ``steps``
    steps): the union of its kernel and copy intervals over their wall, CUDA
    activity only (no host-side tracing)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    steps *= 3
    return (f"{100 * busy_us / window_us:.2f} % ({len(spans) / steps:.1f} device intervals and "
            f"{busy_us / 1e3 / steps:.4f} ms of device activity a step)" if spans
            else "not measured (the profiler recorded no device activity)")


@contextlib.contextmanager
def plain_epochs():
    """Inside ``with``: every epoch function of the trainer (the data
    mesh's too, on one card or several) runs its plain per-step loop, on
    the card too (a measurement's baseline)."""
    call = trainer._Epoch.__call__
    trainer._Epoch.__call__ = trainer._Epoch.plain
    try:
        yield
    finally:
        trainer._Epoch.__call__ = call


def phase_train_times(t: dict, card_line: str) -> None:
    """Phase 17: the plain per-step loop and the epoch graph side by side on
    phase 16's epoch (a step's device ms, an epoch call's host enqueue and
    wall, steps per second, the device's busy share over 3 epochs) and on
    ``train.main`` at the CLI defaults cut to TRAIN_AB_EPOCHS epochs, in
    turns; the walls of phase 16's main-path runs, which took the graph."""
    epoch_fn, params, opt_state, feats, labels, idx = t["epoch"]
    steps = idx.shape[0]
    routes = {"plain": epoch_fn.plain, "graph": epoch_fn}
    m = {}
    for name, fn in routes.items():
        def call(fn=fn, rows=idx):
            return fn(params, opt_state, feats, labels, rows)

        if name == "plain":
            # 4 steps a sample, so that the host enqueues them inside the ~30
            # ms the stream is held and the events time only the device's work
            device, host = event_ms(lambda: call(rows=idx[:1]), batch=4)
            m[name, "step host"] = host
        else:
            device, _ = event_ms(call, batch=1)
            device /= steps
        m[name, "step device"] = device
        enqueue, walls = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        m[name, "enqueue"] = statistics.median(enqueue) * 1e3
        m[name, "wall"] = statistics.median(walls)
        m[name, "busy"] = busy_share(call, steps)
    cli = {}
    for name in ("plain", "graph", "graph", "plain"):
        with TrainSpy() as spy, (plain_epochs() if name == "plain" else contextlib.nullcontext()):
            wall = run_train(t["argv"] + ["-o", os.path.join(t["tmp"], f"ab_{name}.txt"),
                                          "--epochs", str(TRAIN_AB_EPOCHS)])
        cli.setdefault(name, []).append((wall, spy.runs[0]["steps"] / spy.runs[0]["wall"]))
    # train.main --data-parallel: one shard a card, so on one card the
    # one-shard data mesh, whose nets must be those written without the flag
    dp = {}
    for name in ("plain", "graph", "graph", "plain"):
        net = os.path.join(t["tmp"], f"ab_dp_{name}.txt")
        with TrainSpy() as spy, (plain_epochs() if name == "plain" else contextlib.nullcontext()):
            wall = run_train(t["argv"] + ["-o", net, "--epochs", str(TRAIN_AB_EPOCHS),
                                          "--data-parallel"])
        dp.setdefault(name, []).append((wall, spy.runs[0]["steps"] / spy.runs[0]["wall"]))
        with open(net, "rb") as a, open(os.path.join(t["tmp"], f"ab_{name}.txt"), "rb") as b:
            if torch.cuda.device_count() == 1 and a.read() != b.read():
                raise AssertionError(f"train.main --data-parallel ({name}) wrote another net "
                                     "than train.main without the flag")
    run, ens = t["run"], t["ens_run"]

    def both(key, fmt):
        return " / ".join(format(m[name, key], fmt) for name in routes)

    print(
        f"phase 17 times [{card_line}]: plain per-step loop / epoch graph, phase 16's epoch "
        f"(4 inits, batch 256, 290 features, {steps} steps): a step {both('step device', '.4f')} ms "
        f"device (medians of 21 x 4 steps / of 21 epochs over their steps); the plain loop's "
        f"host enqueue {m['plain', 'step host']:.4f} ms a step; one epoch call's host enqueue "
        f"{both('enqueue', '.3f')} ms, to completion {both('wall', '.4f')} s (medians of 3) = "
        f"{steps / m['plain', 'wall']:.1f} / {steps / m['graph', 'wall']:.1f} steps/s; device "
        f"busy over 3 epochs {m['plain', 'busy']} / {m['graph', 'busy']}; train.main at the CLI "
        f"defaults cut to {TRAIN_AB_EPOCHS} epochs, plain, graph, graph, plain: "
        + "; ".join(f"{name} " + ", ".join(f"{w:.3f} s ({r:.1f} steps/s)" for w, r in cli[name])
                    for name in routes),
        flush=True,
    )
    print(
        f"phase 17 times [{card_line}]: train.main --data-parallel ({torch.cuda.device_count()} "
        f"shard(s), one a card) at the CLI defaults cut to {TRAIN_AB_EPOCHS} epochs, plain, "
        f"graph, graph, plain: "
        + "; ".join(f"{name} " + ", ".join(f"{w:.3f} s ({r:.1f} steps/s)" for w, r in dp[name])
                    for name in routes)
        + ("; each net file byte for byte that of the same route without the flag"
           if torch.cuda.device_count() == 1 else ""),
        flush=True,
    )
    print(
        f"phase 17 times [{card_line}]: the main path's graph runs: train.main on the "
        f"{TRAIN_SECONDS:g} s file (read, features, fit, 300 epochs, export) {t['cli_wall']:.3f} s, "
        f"its epoch loop {run['wall']:.3f} s for {run['steps']} steps = "
        f"{run['steps'] / run['wall']:.1f} steps/s; the {ENSEMBLE_CHANNELS}-channel ensemble's "
        f"train.main {t['ens_wall']:.3f} s, its epoch loop {ens['wall']:.3f} s for "
        f"{ens['steps']} steps = {ens['steps'] / ens['wall']:.1f} steps/s",
        flush=True,
    )


def compute_pids() -> set[int]:
    """Processes that hold a context on the card, as nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return {int(v) for v in out.split() if v.strip().isdigit()}


def holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a device file of the card open (a CUDA
    context opens /dev/nvidia*; importing torch does not)."""
    fds = f"/proc/{pid}/fd"
    targets = []
    for fd in os.listdir(fds):
        with contextlib.suppress(OSError):
            targets.append(os.readlink(os.path.join(fds, fd)))
    return any(t.startswith("/dev/nvidia") for t in targets)


def on_card(pids: list[int]) -> tuple[list[int], str]:
    """Which of ``pids`` hold the card, and nvidia-smi's list. Where
    nvidia-smi sees this process (it lists this container's processes),
    its list must agree with the device files."""
    listed = compute_pids()
    holding = [p for p in pids if holds_card(p)]
    if os.getpid() in listed and sorted(p for p in pids if p in listed) != sorted(holding):
        raise AssertionError(f"nvidia-smi lists {sorted(listed)}; device files open in {holding}")
    return holding, (f"nvidia-smi lists {sorted(listed)}" if listed
                     else "nvidia-smi lists no process of this container")


def lost_samples(lines: list[str], channels: int) -> int:
    """Capture samples lost over every channel: the ``lost`` column of the
    monitor's last table, the ``channels`` rows before its detections line."""
    end = next(i for i, s in enumerate(lines) if s.startswith("detections per channel:"))
    return sum(int(s.split()[-1]) for s in lines[end - channels : end])


def detections_of(lines: list[str]) -> list[int]:
    line = [s for s in lines if s.startswith("detections per channel:")]
    if len(line) != 1:
        raise AssertionError(f"no detections line in {lines[-5:]}")
    return json.loads(line[0].split(":", 1)[1])


@contextlib.contextmanager
def injected(module, name: str, lib):
    """``module.name()`` returns ``lib`` (a fake sound library) inside."""
    saved = getattr(module, name)
    setattr(module, name, lambda: lib)
    try:
        yield lib
    finally:
        setattr(module, name, saved)


def phase_capture(tmp: str, audio: np.ndarray, card_line: str) -> dict:
    """Phase 18, this slice's capture path, every count from 0: the device
    listing; 256 channels captured through ALSA and through PulseAudio (fake
    libraries replaying phase 7's audio on every channel, TTL pulses on
    their playback) against the simulated input on the same samples; a
    scripted interactive session against the monitor's run."""
    lines, _ = run_monitor(["--list-devices"])
    print(f"phase 18 capture: monitor --list-devices rc 0: {' | '.join(lines[:4])}", flush=True)
    nets = [a for i in range(LANES) for a in ("-n", os.path.join(tmp, f"live{i}.txt"))]
    wav = os.path.join(tmp, "live.wav")
    total = int(CAPTURE_SECONDS * NET_RATE)
    common = nets + ["--channels", str(LANES), "--batched-drain", "--wire-format", "int16",
                     "--buckets", "128", "--duration", str(CAPTURE_SECONDS), "--frame-size",
                     str(CAPTURE_FRAMES), "--refresh", str(CAPTURE_SECONDS), "--device", "cuda"]
    sim_log = os.path.join(tmp, "capture-sim.csv")
    out, sim_wall = run_monitor(common + ["-a", wav, "--event-log", sim_log])
    want = detections_of(out)
    launches = {}
    for kind, lib, module, name in (
        ("alsa", fixtures.ReplayAlsa, monitor.alsa, "_load_alsa"),
        ("pulse", fixtures.ReplayPulse, monitor.pulse, "_load_pulse"),
    ):
        log = os.path.join(tmp, f"capture-{kind}.csv")
        with injected(module, name, lib(audio, LANES, total=total)) as fake:
            reset_counts()
            out, wall = run_monitor(common + ["--input", kind, "--output", kind,
                                              "--event-log", log])
            launches[kind] = fused.PROGRAM_LAUNCHES["int16"]
        got = detections_of(out)
        lost = lost_samples(out, LANES)
        if lost:
            raise AssertionError(f"{kind} capture: {lost} samples lost")
        if launches[kind] <= 0:
            raise AssertionError(f"{kind} capture: K1f was not launched")
        if fake.delivered != total:
            raise AssertionError(f"{kind} capture: {fake.delivered} of {total} frames delivered")
        if got != want:
            raise AssertionError(f"{kind} capture: detections {sum(got)} against {sum(want)}")
        rows, worst = compare_events(log, sim_log, f"{kind} capture")
        pulses = fake.pulses
        wrong = np.flatnonzero(((pulses > 0) != (np.array(got) > 0)) | (pulses > np.array(got)))
        if len(wrong):
            raise AssertionError(
                f"{kind} capture: TTL pulses {pulses[wrong].tolist()[:8]} against detections "
                f"{np.array(got)[wrong].tolist()[:8]} on channels {wrong.tolist()[:8]}")
        print(
            f"phase 18 capture [{card_line}]: --input {kind} --output {kind}, {LANES} channels x "
            f"{CAPTURE_SECONDS:g} s through a fake library ({CAPTURE_FRAMES} frames a read), "
            f"--batched-drain int16 --buckets 128: {rows} events equal to --input sim in columns "
            f"1-3 (outputs max diff {worst:.3g}), {int(pulses.sum())} TTL pulses on "
            f"{int((pulses > 0).sum())} channels, every channel that detected and no other; "
            f"K1f int16 launches {launches[kind]}; capture lost samples {lost}; wall {wall:.2f} s "
            f"for {CAPTURE_SECONDS:g} s of audio (sim {sim_wall:.2f} s) ok",
            flush=True,
        )

    eight = [a for i in range(8) for a in ("-n", os.path.join(tmp, f"live{i}.txt"))]
    opts = ["-a", wav, "--duration", "3", "--batched-drain", "--wire-format", "int16",
            "--buckets", "128", "--device", "cuda"]
    ilog, mlog = os.path.join(tmp, "interactive.csv"), os.path.join(tmp, "interactive-main.csv")
    script = iter([f"load {i} {eight[2 * i + 1]}" for i in range(8)]
                  + ["start", "table", "stop", "quit"])
    replies = []
    reset_counts()
    rc = monitor.interactive_loop(
        monitor._build_parser().parse_args(["--interactive", *opts, "--event-log", ilog]),
        input_fn=lambda _: next(script), out=replies.append)
    launches["interactive"] = fused.PROGRAM_LAUNCHES["int16"]
    stopped = [r for r in replies if r.startswith("stopped; detections per channel:")]
    if rc != 0 or len(stopped) != 1 or launches["interactive"] <= 0:
        raise AssertionError(f"interactive session: rc {rc}, {replies[-4:]}")
    out, _ = run_monitor(eight + opts + ["--channels", "8", "--refresh", "600",
                                         "--event-log", mlog])
    if json.loads(stopped[0].split(":", 1)[1]) != detections_of(out):
        raise AssertionError(f"interactive session: {stopped[0]} against {out[-2]}")
    rows, worst = compare_events(ilog, mlog, "interactive")
    print(
        f"phase 18 capture: --interactive (load 8 rows, start, table, stop, quit) on the card, "
        f"batched int16: {rows} events equal to monitor.main's in columns 1-3 (max diff "
        f"{worst:.3g}); K1f int16 launches {launches['interactive']} ok",
        flush=True,
    )
    return launches


def phase_resilient(cfgs, card_line: str) -> dict:
    """Phase 19: ResilientDetector on the card, 16 lanes x 60 s with per-lane
    nets, two child crashes mid-stream, against an in-process fused bank on
    the same chunks; the child's pid among the card's compute processes.
    Each child reports its own K1e launches, read just before it is crashed
    and before the last one closes: every child launched, and all of them
    together as often as the in-process bank (counted around its drains
    alone)."""
    from syllable_detector_tpu_torch.runtime.resilient import ResilientDetector

    lanes = cfgs[:RESILIENT_LANES]
    streams = [fixtures.chirp_audio(RESILIENT_SECONDS, 300 + i) for i in range(len(lanes))]
    n_chunks = len(streams[0]) // RESILIENT_CHUNK
    crashes = (n_chunks // 3, 2 * n_chunks // 3)
    oracle = DetectorBank(lanes, device="cuda")
    child, listed = None, ""
    got, want = [[] for _ in lanes], [[] for _ in lanes]
    reset_counts()
    t0 = time.perf_counter()
    r = ResilientDetector(lanes, device="cuda", timeout=600.0)
    start_s = time.perf_counter() - t0
    drains, recover, children = [], [], []
    oracle_k1e = 0
    try:
        for k in range(n_chunks):
            for lane, s in enumerate(streams):
                chunk = s[k * RESILIENT_CHUNK : (k + 1) * RESILIENT_CHUNK]
                r.append_audio_data(chunk, lane=lane)
                oracle.append_audio_data(lane, chunk)
            if k in crashes:
                children.append(r.kernel_launches()["batch"])
                r.crash_for_test()
            t = time.perf_counter()
            out = r.drain()
            (recover if k in crashes else drains).append(time.perf_counter() - t)
            if k == 0:
                child = r.child_pid
                holding, listed = on_card([child, os.getpid()])
                if child not in holding:
                    raise AssertionError(f"the child {child} does not hold the card ({listed})")
            before = fused.BATCH_LAUNCHES
            o = oracle.drain()
            oracle_k1e += fused.BATCH_LAUNCHES - before
            for lane in range(len(lanes)):
                got[lane].append(out[lane, : r.last_counts[lane]])
                want[lane].append(o[lane, : oracle.last_counts[lane]])
                if not np.array_equal(r.last_sample_indices[lane], oracle.last_sample_indices[lane]):
                    raise AssertionError(f"resilient round {k} lane {lane}: sample indices differ")
        restarts = r.restarts
        children.append(r.kernel_launches()["batch"])
    finally:
        r.close()
    k1e = sum(children)
    worst = 0.0
    for lane in range(len(lanes)):
        g, w = np.concatenate(got[lane]), np.concatenate(want[lane])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"resilient lane {lane}")
        worst = max(worst, float(np.nanmax(np.abs(g - w))) if len(g) else 0.0)
    if restarts != len(crashes) or min(children) <= 0 or k1e != oracle_k1e:
        raise AssertionError(f"resilient: {restarts} restarts, the children's K1e launches "
                             f"{children}, the in-process bank's {oracle_k1e}")
    print(
        f"phase 19 resilient [{card_line}]: {len(lanes)} lanes x {RESILIENT_SECONDS:g} s, per-lane "
        f"nets, {n_chunks} chunks of {RESILIENT_CHUNK}, {restarts} child crashes recovered: outputs "
        f"against the in-process fused bank max_abs {worst:.3g} (atol 1e-6), indices equal; the "
        f"child (pid {child}) holds the card ({listed}); start "
        f"{start_s:.3f} s, first drain {drains[0]:.3f} s (loads the kernel library), drain median "
        f"{statistics.median(drains[1:]) * 1e3:.2f} ms, recovery (respawn, restore, replay, drain) "
        f"{', '.join(f'{v:.3f}' for v in recover)} s; K1e launches in the children "
        f"{' + '.join(map(str, children))} = {k1e}, in the in-process bank {oracle_k1e} ok",
        flush=True,
    )
    return {"recover": recover, "first": drains[0], "err": worst, "k1e": k1e}


def feed(bank, rolled, start: int, n: int, gap: bool = False) -> None:
    """Append ``n`` samples from ``start`` of each lane's stream to ``bank``
    (with ``gap``, every 4th lane first loses 1000 samples)."""
    for lane, x in enumerate(rolled):
        if gap and lane % 4 == 0:
            bank.note_gap(lane, 1000)
        bank.append_audio_data(lane, x[start : start + n])


def same_round(bank, got, oracle, want, lanes=None) -> bool:
    """Whether a drain of ``bank`` gave ``oracle``'s counts, sample indices
    and valid outputs, bit for bit, on ``lanes`` (default: all, and the
    same padded shape)."""
    if lanes is None:
        lanes = range(bank.n_lanes)
        if got.shape != want.shape:
            return False
    for i in lanes:
        c = int(oracle.last_counts[i])
        if not (int(bank.last_counts[i]) == c
                and np.array_equal(got[i, :c], want[i, :c], equal_nan=True)
                and np.array_equal(bank.last_sample_indices[i], oracle.last_sample_indices[i])):
            return False
    return True


def host_median_ms(fn, samples: int = 21) -> float:
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def shard_rate(bank, rolled, start: int, hop_block: int, paused: bool) -> tuple:
    """Host times of ``bank`` (fed from ``start`` of each lane's stream,
    wrapping): the median ms of a ``drain()`` round and the audio seconds
    per wall second of rounds of appends and a drain, over SHARD_ROUNDS
    rounds after SHARD_WARM; with ``paused``, also the median ms of a drain
    issued SHARD_PAUSE s after its appends, once the workers have taken
    them in (staging, the round trips and the evaluation alone)."""
    n = len(rolled[0]) - hop_block
    drain_s, wall, alone = [], 0.0, []
    rounds = SHARD_WARM + SHARD_ROUNDS
    for r in range(rounds + (SHARD_PAUSED if paused else 0)):
        t0 = time.perf_counter()
        feed(bank, rolled, (start + r * hop_block) % n, hop_block)
        if r >= rounds:
            time.sleep(SHARD_PAUSE)
        t1 = time.perf_counter()
        bank.drain()
        t2 = time.perf_counter()
        if r >= rounds:
            alone.append(t2 - t1)
        elif r >= SHARD_WARM:
            drain_s.append(t2 - t1)
            wall += t2 - t0
    lanes = len(rolled)
    return (statistics.median(drain_s) * 1e3,
            lanes * SHARD_ROUNDS * hop_block / NET_RATE / wall,
            statistics.median(alone) * 1e3 if alone else None)


def phase_shard(cfgs, audio: np.ndarray, card_line: str) -> dict:
    """Phase 20: ShardedDetectorBank on the card, 256 lanes, int16 wire,
    ladder (128,), per-lane nets, with 2 and 4 workers: every round bit for
    bit the single-process bank's, K1f counted in this process around the
    sharded bank's drains alone (one launch a worker a round), no worker
    holding the card, K1f at a shard's shape against its plain version and
    timed, and a round a worker fails followed by an aligned one; then host
    ms per drain() round and audio s per wall s at 256 and 512 lanes, for
    the single-process bank and 2 and 4 workers."""
    from syllable_detector_tpu_torch.runtime.shard_bank import ShardedDetectorBank

    spec = detector.detector_spec_from_config(cfgs[0], "cpu")[0]
    hop_block = 128 * spec.hop
    first = bucket_samples(spec, 128) - hop_block
    kw = dict(transfer_dtype="int16", buckets=(128,), device="cuda")
    rolled = [np.roll(audio, 97 * lane) for lane in range(SHARD_LANES[-1])]
    # the rate rounds start where the checks' rounds end
    later = first + (SHARD_ROUNDS + 2) * hop_block
    result, rates = {}, {}
    for workers in SHARD_WORKERS:
        oracle = DetectorBank(cfgs, **kw)
        bank = ShardedDetectorBank(cfgs, n_workers=workers, **kw)
        try:
            warm = bank.warm_up()
            for b in (bank, oracle):
                feed(b, rolled[:LANES], 0, first)
            k1f = 0
            for r in range(SHARD_ROUNDS):
                start = first + r * hop_block
                for b in (bank, oracle):
                    feed(b, rolled[:LANES], start, hop_block, gap=r == 3)
                reset_counts()
                got = bank.drain()
                launched = fused.PROGRAM_LAUNCHES["int16"]
                want = oracle.drain()
                if launched != workers:
                    raise AssertionError(f"{workers} workers: round {r} launched K1f {launched} "
                                         f"times in the sharded bank's drain")
                k1f += launched
                if not same_round(bank, got, oracle, want) or int(bank.last_counts.max()) <= 0:
                    raise AssertionError(f"{workers} workers: round {r} differs from one process")
            holding, listed = on_card([*bank.worker_pids, os.getpid()])
            if holding != [os.getpid()]:
                raise AssertionError(f"holding the card {holding} of workers {bank.worker_pids} "
                                     f"({listed})")
            result[workers, "kernel"] = shard_kernel(bank, spec, card_line)
            # worker 0 fails one drain (its bank rejects a command); every
            # reply of that round is read, so the next round is aligned
            bank._cmd_qs[0].put(("append", 10**6, np.zeros(4, np.float32)))
            start = first + SHARD_ROUNDS * hop_block
            for b in (bank, oracle):
                feed(b, rolled[:LANES], start, hop_block)
            try:
                bank.drain()
                raise AssertionError("the injected worker failure did not raise")
            except RuntimeError as e:
                if "worker 0 drain failed" not in str(e):
                    raise
            skipped, s_counts = oracle.drain(), oracle.last_counts.copy()
            s_idx = [a.copy() for a in oracle.last_sample_indices]
            for b in (bank, oracle):
                feed(b, rolled[:LANES], start + hop_block, hop_block)
            got, want = bank.drain(), oracle.drain()
            w0 = int(bank._offsets[1])
            if not same_round(bank, got, oracle, want, range(w0, LANES)):
                raise AssertionError(f"{workers} workers: the round after a failure is not aligned")
            for lane in range(w0):
                c0, c1 = int(s_counts[lane]), int(oracle.last_counts[lane])
                both = np.concatenate([skipped[lane, :c0], want[lane, :c1]])
                if not (int(bank.last_counts[lane]) == c0 + c1
                        and np.array_equal(got[lane, : c0 + c1], both, equal_nan=True)
                        and np.array_equal(bank.last_sample_indices[lane],
                                           np.concatenate([s_idx[lane],
                                                           oracle.last_sample_indices[lane]]))):
                    raise AssertionError(f"{workers} workers: worker 0 lane {lane} after its failure")
            if workers == SHARD_WORKERS[0]:
                result["upload"] = arena_uploads(bank, spec)
                rates[LANES, 1] = shard_rate(oracle, rolled[:LANES], later, hop_block, False)
            rates[LANES, workers] = shard_rate(bank, rolled[:LANES], later, hop_block, True)
        finally:
            bank.close()
        print(
            f"phase 20 shard bank [{card_line}]: {LANES} lanes, int16, ladder (128,), per-lane "
            f"nets, {workers} workers (pids {bank.worker_pids}, none holds the card; {listed}): "
            f"warm-up {warm} rounds, {SHARD_ROUNDS} rounds (a gap on every 4th "
            f"lane) bit for bit the single-process bank's; K1f int16 launches in the sharded "
            f"bank's drains {k1f} ({workers} a round); a round worker 0 failed raised after every "
            f"reply, and the next round was aligned (worker 0's lanes delivered both rounds) ok",
            flush=True,
        )
        result[workers] = k1f

    lanes = SHARD_LANES[-1]
    nets = list(cfgs) + [fixtures.sample_geometry_config(2000 + i) for i in range(lanes - len(cfgs))]
    for workers in (1, *SHARD_WORKERS):
        bank = (DetectorBank(nets, **kw) if workers == 1
                else ShardedDetectorBank(nets, n_workers=workers, **kw))
        try:
            bank.warm_up()
            feed(bank, rolled, 0, first)
            rates[lanes, workers] = shard_rate(bank, rolled, first, hop_block, workers > 1)
        finally:
            if workers > 1:
                bank.close()
    for lanes in SHARD_LANES:
        print(
            f"phase 20 shard times [{card_line}]: {lanes} lanes, int16, bucket 128, median of "
            f"{SHARD_ROUNDS} rounds after {SHARD_WARM}, host clock: "
            + "; ".join(
                f"{'1 process' if w == 1 else f'{w} workers'} {rates[lanes, w][0]:.3f} ms a "
                f"drain() round right after its appends"
                + (f" ({rates[lanes, w][2]:.3f} ms {SHARD_PAUSE:g} s after them, median of "
                   f"{SHARD_PAUSED})" if w > 1 else "")
                + f", {rates[lanes, w][1]:.1f} audio s per wall s (appends included)"
                for w in (1, *SHARD_WORKERS)),
            flush=True,
        )
    result["rates"] = rates
    return result


def shard_kernel(bank, spec, card_line: str) -> tuple:
    """K1f at the shape the sharded bank launches it: each worker's last
    staged round, read from its request arena, through the eval bank's
    drain program of that shard (its own nets) against the plain version
    (rtol=1e-3, atol=2e-4, phase 6's bound); worker 0's round timed.
    Returns (max_abs_err, (kernel ms, plain ms), bound)."""
    srv = bank._server
    need = bucket_samples(spec, 128)
    worst = 0.0
    for w, ev in enumerate(srv.banks):
        prog = ev._program(need)
        xd = prog.upload(srv.request(w, need))
        got = prog.launch(xd)
        plain = fused.fused_batch_outputs_reference(spec, prog.folded, xd, "int16", prog.n_evals)
        worst = max(worst, held(got, plain, 1e-3, 2e-4, f"shard {w} of {len(srv.banks)}"))
        if w == 0:
            kernel = event_ms(lambda: prog.launch(xd))
            plain_ms = event_ms(lambda: fused.fused_batch_outputs_reference(
                spec, prog.folded, xd, "int16", prog.n_evals))
            lanes = xd.shape[0]
            least = fused_bound(spec, lanes, need, 2, lanes)
    print(
        f"phase 20 shard kernel [{card_line}]: K1f int16 at a shard's shape [{lanes}, {need}] "
        f"({len(srv.banks)} workers), each worker's last round from its arena with its "
        f"shard's nets: vs plain max_abs {worst:.3g} (rtol=1e-3, atol=2e-4); worker 0's round, "
        f"median of 21 x 10 calls: kernel {kernel[0]:.4f} ms device ({kernel[1]:.4f} ms host "
        f"enqueue), plain {plain_ms[0]:.4f} ms device; bound {least[0]:.4f} ms ({least[1]}); "
        f"tile: {tile_of(spec, lanes, need)}",
        flush=True,
    )
    return worst, (kernel[0], plain_ms[0]), least


def arena_uploads(bank, spec) -> dict:
    """Host ms of a round's upload from a worker's registered request arena,
    beside a copy into the eval bank's pinned staging then its upload, and an
    upload from pageable memory."""
    srv = bank._server
    need = bucket_samples(spec, 128)
    xs = srv.request(0, need)
    ev = srv.banks[0]
    prog, pinned = ev._program(need), ev._staging(need)[1]
    pageable = xs.clone()

    def copied():
        pinned.copy_(xs)
        prog.upload(pinned)

    times = {"registered arena": host_median_ms(lambda: prog.upload(xs)),
             "copy to pinned, upload": host_median_ms(copied),
             "pageable": host_median_ms(lambda: prog.upload(pageable))}
    print(
        f"phase 20 shard upload: one worker's [{xs.shape[0]}, {need}] int16 round "
        f"({xs.numel() * 2} bytes), host ms to completion, median of 21: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; the arena reads as pinned: {xs.is_pinned()}",
        flush=True,
    )
    return times


def phase_tune(tmp: str, card_line: str) -> dict:
    """Phase 21: ``python -m syllable_detector_tpu_torch tune`` for every
    workload at the sample geometry, the cache it writes, and K1a and K1e
    under the cached choice, and under the other candidate, against their
    plain versions."""
    from syllable_detector_tpu_torch import tuning

    net = os.path.join(tmp, "live0.txt")
    proc = subprocess.run(
        [sys.executable, "-m", "syllable_detector_tpu_torch", "tune", "-n", net, "--workload",
         "all", "--channels", str(TUNE_LANES), "--n-evals", str(TUNE_EVALS)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"tune returned {proc.returncode}: {proc.stderr[-2000:]}")
    with open(tuning.tune_cache_path()) as fh:
        cache = json.load(fh)
    kind = f"r{tuning.KERNEL_REVISION}/{tuning.device_kind('cuda')}/"
    if len(cache) != 3 or not all(k.startswith(kind) for k in cache):
        raise AssertionError(f"the tune cache holds {list(cache)}")
    tuning.reset_tune_cache()
    for key, entry in sorted(cache.items()):
        workload, lanes, evals = key.split("/")[-3:]
        print(
            f"phase 21 tune [{card_line}]: {workload} {lanes} {evals}: "
            + ", ".join(f"frames {f} {ms:.4f} ms" for f, ms in sorted(entry["trials"]))
            + f"; chosen {entry['frames']}, analytic {entry['analytic']}",
            flush=True,
        )

    spec, params = detector.detector_spec_from_config(load_config(net), "cuda")
    width = max(w for _, w in spec.net.layer_sizes)
    stream = torch.from_numpy(fixtures.chirp_audio(60.0, 5)).cuda()
    n = bucket_samples(spec, TUNE_EVALS)
    xs = torch.stack([torch.roll(stream[:n], 97 * lane) for lane in range(TUNE_LANES)])
    nets = [perturbed(params, lane) for lane in range(TUNE_LANES)]
    shared = fused.fold_constants(spec, params, "cuda")
    folded = {"single": shared, "batched": shared,
              "distinct": fused.fold_constants_stacked(spec, nets, "cuda")}
    runs = {
        "single": (lambda: fused.fused_offline_outputs(spec, params, stream, folded=folded["single"]),
                   lambda: fused.fused_offline_outputs_reference(spec, folded["single"], stream),
                   1, stream.shape[0], lambda: fused.LAUNCHES),
        "batched": (lambda: fused.fused_flat_batch_offline_outputs(spec, params, xs,
                                                                   folded=shared),
                    lambda: fused.fused_batch_outputs_reference(spec, shared, xs),
                    TUNE_LANES, n, lambda: fused.BATCH_LAUNCHES),
        "distinct": (lambda: fused.fused_flat_batch_offline_outputs(spec, nets, xs,
                                                                    folded=folded["distinct"]),
                     lambda: fused.fused_batch_outputs_reference(spec, folded["distinct"], xs),
                     TUNE_LANES, n, lambda: fused.BATCH_LAUNCHES),
    }
    out = {}
    for workload, (kernel, plain, lanes, samples, count) in runs.items():
        evals = num_frames(samples, spec.window_length, spec.window_overlap) - spec.time_range + 1
        analytic = fused.cta_frames(spec, evals, lanes, width)
        tuned = fused.cta_frames(spec, evals, lanes, width, workload=workload, device_kind=kind)
        want = plain()
        for frames in (tuned, *(f for f in fused.CTA_FRAMES if f != tuned)):
            tuning._save_entry(tuning.tune_key(kind, spec, workload, lanes, evals),
                               {"frames": frames})
            if fused.cta_frames(spec, evals, lanes, width, workload=workload,
                                device_kind=kind) != frames:
                raise AssertionError(f"{workload}: the cached choice {frames} was not taken")
            reset_counts()
            got = kernel()
            launched = count()
            err = held(got, want, 1e-3, 2e-4, f"{workload} at frames {frames}")
            if launched != 1:
                raise AssertionError(f"{workload} at frames {frames}: {launched} launches")
            ms = event_ms(kernel)[0]
            if frames == tuned:
                out[workload] = (launched, err, ms, event_ms(plain)[0],
                                 fused_bound(spec, lanes, samples, 4,
                                             lanes if workload == "distinct" else 1))
            print(
                f"phase 21 tune [{card_line}]: {'K1a' if lanes == 1 else 'K1e'} {workload} "
                f"({lanes} x {evals} evals) at {frames} frames a CTA "
                f"({'the tuned choice' if frames == tuned else 'the other candidate'}; analytic "
                f"{analytic}): vs plain max_abs {err:.3g} (rtol=1e-3, atol=2e-4), {ms:.4f} ms, "
                f"launches {launched} ok",
                flush=True,
            )
    return out


def geometry_audio(rate: float, seed: int) -> np.ndarray:
    """GEOMETRY_SECONDS of seeded audio at ``rate``, as the JAX fuzz test
    makes it (noise with an offset and a floor tone), with a tenth of a
    second of digital silence: NaN under l2normalize."""
    rng = np.random.default_rng(seed)
    n = int(GEOMETRY_SECONDS * rate)
    x = (rng.standard_normal(n) * 0.3 + 0.05).astype(np.float32)
    x += 0.05 * np.sin(2 * np.pi * 0.1 * np.arange(n)).astype(np.float32)
    x[n // 3 : n // 3 + int(0.1 * rate)] = 0.0
    return x


def repeated_fold(folded, lanes: int):
    """``folded`` (one net) as ``lanes`` per-lane copies of it."""
    def rep(t):
        return t[None].expand(lanes, *t.shape).contiguous()

    return folded._replace(
        w1=rep(folded.w1), c1=rep(folded.c1),
        mids=tuple((rep(w), rep(b)) for w, b in folded.mids),
        out_a=rep(folded.out_a), out_c=rep(folded.out_c), mids_flat=rep(folded.mids_flat),
        w1g_bf16=rep(folded.w1g_bf16), per_lane=True,
        w1g_tf32=rep(folded.w1g_tf32) if folded.w1g_tf32 is not None else None,
    )


def other_layouts(spec, width: int, chosen, tier, frames_input: bool) -> list[tuple[int, int]]:
    """(frames, col_group) launches other than ``chosen`` (a
    ``fused.CtaChoice``) that fit, for bit-for-bit comparisons: each other
    layout of ``fused.LAYOUTS`` at the chosen frames, else at 64, with the
    most chunks of C a pass that fit; and the chosen layout outside the
    resident one over one chunk a pass."""
    chunks = fused._dft_chunks(spec)

    def fits(frames, group):
        return (frames > spec.time_range - 1 and fused.smem_bytes(
            spec, frames, width, tier, frames_input, group) <= fused.SMEM_LIMIT)

    out = []
    for sign, layout in ((0, "resident"), (-1, "span"), (1, "streamed")):
        if layout == chosen.layout:
            options = [(chosen.frames, sign)] if sign else []
        else:
            options = [(f, sign * g) for f in (chosen.frames, 64)
                       for g in (range(chunks, 0, -1) if sign else (0,))]
        pick = next(((f, g) for f, g in options if (f, g) != tuple(chosen) and fits(f, g)), None)
        if pick is not None:
            out.append(pick)
    return out


def sweep_geometry(name: str, cfg, seed: int, worst: dict, layouts: dict) -> None:
    """Every K1 entry on one geometry against its plain version, and each
    against the same launch in another shared-memory layout bit for bit."""
    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    x = geometry_audio(cfg.sampling_rate, seed)
    xd = torch.from_numpy(x).cuda()
    folded = fused.fold_constants(spec, params, "cuda")
    width = max(w for _, w in spec.net.layer_sizes)
    n_evals = num_frames(len(x), spec.window_length, spec.window_overlap) - spec.time_range + 1
    tol = (2e-3, 5e-4) if spec.scaling != "linear" else (1e-3, 2e-4)
    nets = [perturbed(params, lane) for lane in range(GEOMETRY_LANES)]
    stacked = fused.fold_constants_stacked(spec, nets, "cuda")
    xs = torch.stack([torch.roll(xd, 97 * lane) for lane in range(GEOMETRY_LANES)])
    frames = frame_signal(xd, n_evals + spec.time_range - 1, spec.window_length,
                          spec.window_overlap).contiguous()
    layouts[fused.cta_choice(spec, n_evals, 1, width).layout] += 1
    layouts["tensor-core first layer"] += fused.tc_first_layer(spec)

    def hold(entry, got, plain, rtol, atol):
        worst[entry] = max(worst[entry], held(got, plain, rtol, atol, f"{name} {entry}"))

    def other_layout(entry, got, xs_, lanes, tier=None, wire="float32", frames_input=False,
                     folded_=folded):
        chosen = fused.cta_choice(spec, n_evals, lanes, width, tier=tier,
                                  frames_input=frames_input)
        for other in other_layouts(spec, width, chosen, tier, frames_input):
            again = fused._launch(spec, folded_, xs_, n_evals, wire=wire, tier=tier,
                                  frames_input=frames_input, frames=other[0], col_group=other[1])
            held(again.reshape(got.shape), got, 0.0, 0.0,
                 f"{name} {entry} at {tuple(chosen)} and at {other}")
            layouts["bit equal"] += 1
            layouts["bit equal " + fused.CtaChoice(*other).layout] += 1

    got = fused.fused_offline_outputs(spec, params, xd, folded=folded)
    hold("K1a", got, fused.fused_offline_outputs_reference(spec, folded, xd), *tol)
    other_layout("K1a", got, xd[None], 1)
    got = fused.fused_offline_outputs(spec, params, xd, folded=folded, input_mode="frames")
    hold("K1b", got, fused.fused_frames_outputs_reference(spec, folded, frames), *tol)
    other_layout("K1b", got, frames[None], 1, frames_input=True)
    for tier, kw in TIER_KW.items():
        got = fused.fused_offline_outputs(spec, params, xd, folded=folded, **kw)
        hold(f"K1c {tier}", got, fused.fused_tier_outputs_reference(spec, folded, xd[None], tier)[0],
             *TIER_TOL[tier])
        other_layout(f"K1c {tier}", got, xd[None], 1, tier=tier)
    got = fused.fused_batch_offline_outputs(spec, nets, xs, layout="grid", folded=stacked)
    hold("K1d", got, fused.fused_batch_outputs_reference(spec, stacked, xs), *tol)
    for net_form, p, f in (("shared", params, folded), ("per-lane", nets, stacked)):
        got = fused.fused_flat_batch_offline_outputs(spec, p, xs, folded=f)
        hold(f"K1e {net_form}", got, fused.fused_batch_outputs_reference(spec, f, xs), *tol)
    other_layout("K1e", got, xs, GEOMETRY_LANES, folded_=stacked)
    for wire in ("int16", "mulaw8"):
        xw = torch.from_numpy(to_wire(xs.cpu().numpy(), wire)).cuda()
        prog = fused.BatchProgram(spec, stacked, GEOMETRY_LANES, len(x), n_evals, wire, "cuda")
        got = prog.launch(xw)
        hold(f"K1f {wire}", got,
             fused.fused_batch_outputs_reference(spec, stacked, xw, wire, n_evals), *tol)
        other_layout(f"K1f {wire}", got, xw, GEOMETRY_LANES, wire=wire, folded_=stacked)
        # the streamed layout stages the raw wire and dequantises it where
        # the fragments are loaded: each of its launches equals, bit for
        # bit, the same launch on the float32 wire fed the samples the wire
        # dequantises to
        chosen = fused.cta_choice(spec, n_evals, GEOMETRY_LANES, width)
        xf = fused.dequant(xw, wire).contiguous()
        for frames_, group in [tuple(chosen)] + other_layouts(spec, width, chosen, None, False):
            if fused.CtaChoice(frames_, group).layout != "streamed":
                continue
            a = fused._launch(spec, stacked, xw, n_evals, wire=wire, frames=frames_, col_group=group)
            b = fused._launch(spec, stacked, xf, n_evals, frames=frames_, col_group=group)
            held(a, b, 0.0, 0.0, f"{name} K1f {wire} at {(frames_, group)} against K1e fed "
                 f"its dequantised samples")
            layouts[f"wire bit equal {wire}"] += 1


def time_geometry(name: str, cfg, card_line: str) -> dict:
    """Each K1 entry's device time on one geometry (the 60 s stream, or
    256 lanes x 128 evaluations) beside its plain version and its bound,
    with the layout it took and its stage shares there."""
    spec, params = detector.detector_spec_from_config(cfg, "cuda")
    folded = fused.fold_constants(spec, params, "cuda")
    width = max(w for _, w in spec.net.layer_sizes)
    x = torch.from_numpy(fixtures.chirp_audio(60.0, 23, rate=int(cfg.sampling_rate))).cuda()
    n = x.numel()
    evals = num_frames(n, spec.window_length, spec.window_overlap) - spec.time_range + 1
    frames = frame_signal(x, evals + spec.time_range - 1, spec.window_length, spec.window_overlap)
    n_live = bucket_samples(spec, 128)
    rng = np.random.default_rng(8)
    live = torch.from_numpy(rng.uniform(-0.7, 0.7, (LANES, n_live)).astype(np.float32)).cuda()
    live16 = torch.from_numpy(to_wire(live.cpu().numpy(), "int16")).cuda()
    per_lane = repeated_fold(folded, LANES)
    prog = fused.BatchProgram(spec, per_lane, LANES, n_live, 128, "int16", "cuda")
    live8 = torch.from_numpy(to_wire(live.cpu().numpy(), "mulaw8")).cuda()
    prog8 = fused.BatchProgram(spec, per_lane, LANES, n_live, 128, "mulaw8", "cuda")
    cases = [
        ("K1a", None, False, 1, n, 4,
         lambda: fused.fused_offline_outputs(spec, params, x, folded=folded),
         lambda: fused.fused_offline_outputs_reference(spec, folded, x)),
        ("K1b", None, True, 1, n, 4,
         lambda: fused.fused_offline_outputs(spec, params, x, folded=folded, input_mode="frames"),
         lambda: fused.fused_frames_outputs_reference(spec, folded, frames)),
        *((f"K1c {tier}", tier, False, 1, n, 4,
           lambda kw=kw: fused.fused_offline_outputs(spec, params, x, folded=folded, **kw),
           lambda tier=tier: fused.fused_tier_outputs_reference(spec, folded, x[None], tier))
          for tier, kw in TIER_KW.items()),
        ("K1d", None, False, LANES, n_live, 4,
         lambda: fused.fused_batch_offline_outputs(spec, params, live, layout="grid", folded=folded),
         lambda: fused.fused_batch_outputs_reference(spec, folded, live)),
        ("K1e", None, False, LANES, n_live, 4,
         lambda: fused.fused_flat_batch_offline_outputs(spec, params, live, folded=folded),
         lambda: fused.fused_batch_outputs_reference(spec, folded, live)),
        ("K1f int16", None, False, LANES, n_live, 2,
         lambda: prog.launch(live16),
         lambda: fused.fused_batch_outputs_reference(spec, per_lane, live16, "int16", 128)),
        ("K1f mulaw8", None, False, LANES, n_live, 1,
         lambda: prog8.launch(live8),
         lambda: fused.fused_batch_outputs_reference(spec, per_lane, live8, "mulaw8", 128)),
    ]
    times = {}
    parts = []
    for entry, tier, frames_input, lanes, samples, itemsize, kernel, plain in cases:
        e = num_frames(samples, spec.window_length, spec.window_overlap) - spec.time_range + 1
        choice = fused.cta_choice(spec, e, lanes, width, tier=tier, frames_input=frames_input)
        k = event_ms(kernel, samples=GEOMETRY_TIMES[0], batch=GEOMETRY_TIMES[1])[0]
        p = event_ms(plain, samples=GEOMETRY_TIMES[0], batch=GEOMETRY_TIMES[1])[0]
        least = fused_bound(spec, lanes, samples, itemsize, LANES if entry.startswith("K1f") else 1,
                            tier, frames_input)
        shares = fused.stage_shares(kernel)
        times[entry] = (k, p, least, choice, shares)
        parts.append(f"{entry} {k:.4f} ms (plain {p:.4f}, bound {least[0]:.4f} {least[1]}, "
                     f"{choice.frames} frames {choice.layout}"
                     f"{f' over {abs(choice.col_group)} chunks' if choice.col_group else ''}; "
                     + " ".join(f"{stage} {v:.3f}" for stage, v in shares.items() if v >= 0.005)
                     + ")")
    print(
        f"phase 22 times [{card_line}]: {name} (fft {spec.fourier_length}, window "
        f"{spec.window_length}, hop {spec.hop}, {spec.n_bins} bins, timeRange {spec.time_range}, "
        f"widths {[w for _, w in spec.net.layer_sizes]}, first layer on the "
        f"{'tensor' if fused.tc_first_layer(spec) else 'CUDA'} cores); the 60 s stream ({n} "
        f"samples) for K1a-K1c, {LANES} x 128 evaluations for K1d-K1f; device ms, median of "
        f"{GEOMETRY_TIMES[0]} x {GEOMETRY_TIMES[1]} calls; stage shares of the CTAs' cycles at "
        f"least 0.005: " + "; ".join(parts),
        flush=True,
    )
    return times


def phase_geometry(card_line: str) -> dict:
    """Phase 22: the geometry sweep. Every K1 entry on fuzz seeds
    GEOMETRY_SEEDS and fixtures.wide_geometry_configs() against its plain
    version, and bit for bit against the same launch in another layout; K2
    on every rate pair of fixtures.RESAMPLE_RATES (the resampler's ratio
    and the exact one) against its plain version; the wide geometries'
    times. Returns the worst errors, counts and times."""
    t0 = time.perf_counter()
    entries = ("K1a", "K1b", *(f"K1c {t}" for t in fused.TIERS), "K1d", "K1e shared",
               "K1e per-lane", "K1f int16", "K1f mulaw8")
    worst = {entry: 0.0 for entry in entries}
    layouts = {**{layout: 0 for layout in fused.LAYOUTS}, "tensor-core first layer": 0,
               "bit equal": 0, **{f"bit equal {layout}": 0 for layout in fused.LAYOUTS},
               "wire bit equal int16": 0, "wire bit equal mulaw8": 0}
    geometries = [(f"fuzz{seed}", fixtures.random_config(np.random.default_rng(seed)), seed)
                  for seed in GEOMETRY_SEEDS]
    geometries += [(name, cfg, 77) for name, cfg in fixtures.wide_geometry_configs()]
    swept = 0
    for name, cfg, seed in geometries:
        spec, _ = detector.detector_spec_from_config(cfg, "cpu")
        if fused.fusable(spec):
            sweep_geometry(name, cfg, seed, worst, layouts)
            swept += 1
    torch.cuda.synchronize()
    # K2 on every rate pair, at the resampler's ratio and at the exact one
    k2_worst, narrow, pairs = 0.0, [], 0
    for in_rate in fixtures.RESAMPLE_RATES:
        x = geometry_audio(in_rate, 5)
        for out_rate in fixtures.RESAMPLE_RATES:
            for denominator in (1000, 10**6):
                if out_rate == in_rate:
                    continue
                xin, g, w_len, overlap, blocks, _ = resample.polyphase_framing(
                    x, in_rate, out_rate, max_denominator=denominator, device="cuda")
                got = fg.framed_gemm(xin, g, w_len, overlap, blocks)
                plain = fg.framed_gemm_reference(xin, g, w_len, overlap, blocks)
                k2_worst = max(k2_worst, held(got, plain, 1e-4, 1e-4,
                                              f"K2 {rate_name(in_rate, out_rate)}"))
                pairs += 1
                cut = fg.tiling(w_len, g.shape[1], hop_length(w_len, overlap))
                if cut.fpt != fg.FRAMES_PER_THREAD:
                    narrow.append(f"{rate_name(in_rate, out_rate)} (window {w_len}, hop "
                                  f"{hop_length(w_len, overlap)}, {cut.fpt} frames a thread)")
    torch.cuda.synchronize()
    band_launches = fg.LAUNCH_KINDS["band"]
    sweep_s = time.perf_counter() - t0
    # the CLI on two wide nets, one file at a time and as a batched scan:
    # fused against matmul, as phase 4 holds it
    cli_parts = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("fft1024 overlap900", "96k fft1024"):
            cfg = dict(fixtures.wide_geometry_configs())[name]
            rate = int(cfg.sampling_rate)
            audio = np.stack([fixtures.chirp_audio(4.0, 61, rate=rate),
                              fixtures.chirp_audio(4.0, 62, rate=rate)], 1)
            cfg = fixtures.pick_thresholds(cfg, audio, margin=2e-4, device="cuda")
            net, wav = os.path.join(tmp, "wide.txt"), os.path.join(tmp, "wide.wav")
            save_config(cfg, net)
            write_wav(wav, audio, rate, dtype="float32")
            for mode in ([], ["--batched"]):
                argv = ["-n", net, "-a", wav, "--device", "cuda", *mode]
                fused_csv = run_cli(argv + ["--method", "fused"])[0]
                worst_csv = compare_csv(fused_csv, run_cli(argv + ["--method", "matmul"])[0])
                if not fused_csv:
                    raise AssertionError(f"{name} {mode}: no detection")
                cli_parts.append(f"{name}{' --batched' if mode else ''} {len(fused_csv)} lines, "
                                 f"max diff {worst_csv:.3g}")
    print(
        f"phase 22 geometry sweep: {swept} fusable geometries of {len(geometries)} (fuzz seeds "
        f"{GEOMETRY_SEEDS.start}-{GEOMETRY_SEEDS.stop - 1} and {len(geometries) - len(GEOMETRY_SEEDS)} "
        f"wide ones, {GEOMETRY_SECONDS:g} s of audio each), K1a by layout: "
        + ", ".join(f"{layouts[layout]} {layout}" for layout in fused.LAYOUTS)
        + f", {layouts['tensor-core first layer']} with the first layer on the tensor cores; "
        f"{layouts['bit equal']} launches equal bit for bit in another layout ("
        + ", ".join(f"{layouts['bit equal ' + layout]} {layout}" for layout in fused.LAYOUTS)
        + f"); K1f on the streamed layout bit for bit K1e fed its dequantised samples on "
        f"{layouts['wire bit equal int16']} int16 and {layouts['wire bit equal mulaw8']} mu-law "
        f"launches; launches by layout {fused.LAYOUT_LAUNCHES}; worst vs plain max_abs: "
        + ", ".join(f"{entry} {err:.3g}" for entry, err in worst.items())
        + f" (1e-3/2e-4, log and dB 2e-3/5e-4, tiers as phase 12; NaN in the same places); "
        f"K2 on {pairs} rate pairs of {len(fixtures.RESAMPLE_RATES)} rates vs plain max_abs "
        f"{k2_worst:.3g} (1e-4/1e-4), narrow tiling on {', '.join(narrow) or 'none'}; "
        f"{sweep_s:.1f} s ok",
        flush=True,
    )
    print(f"phase 22 entry points: cli --method fused vs matmul on 2 x 4 s: "
          f"{'; '.join(cli_parts)}; columns 1-3 identical ok", flush=True)
    times = {name: time_geometry(name, cfg, card_line)
             for name, cfg in fixtures.wide_geometry_configs()}
    # each layout that fits, its time and stage shares, where the resident
    # layout does not fit or T*h1 is wide
    configs = dict(fixtures.wide_geometry_configs())
    for name in stage_shares_script.GEOMETRIES:
        rows = stage_shares_script.layout_shares(name, configs[name], card_line)
        print(f"phase 22 layouts [{card_line}]: {name}, device ms and stage shares of each "
              f"layout that fits: " + "; ".join(
                  f"{r['entry']} {r['frames']} frames {r['layout']} over {abs(r['col_group'])} "
                  f"chunks{' (chosen)' if r['chosen'] else ''} {r['ms']:.4f} ms: "
                  + " ".join(f"{k} {v:.3f}" for k, v in r['shares'].items() if v >= 0.005)
                  for r in rows), flush=True)
    # K2 where a thread takes fewer frames: one 60 s channel at 192k -> 11.025k
    x = fixtures.chirp_audio(60.0, 92, rate=192000)
    xin, g, w_len, overlap, blocks, _ = resample.polyphase_framing(
        x, 192000, 11025, max_denominator=10**6, device="cuda")
    hop = hop_length(w_len, overlap)
    need = (blocks - 1) * hop + w_len
    xpad = torch.cat([xin, xin.new_zeros(max(0, need - xin.numel()))])[:need]
    k2 = [event_ms(fn, samples=GEOMETRY_TIMES[0], batch=GEOMETRY_TIMES[1])[0] for fn in (
        lambda: fg.framed_gemm(xin, g, w_len, overlap, blocks),
        lambda: fg.framed_gemm_reference(xin, g, w_len, overlap, blocks),
        lambda: xpad.unfold(0, w_len, hop) @ g)]
    k2_least = framed_bound(xin, g, blocks)
    print(
        f"phase 22 times [{card_line}]: K2 192k->11.025k at the exact ratio, one 60 s channel "
        f"([{xin.numel()}] x [{w_len}, {g.shape[1]}] -> [{blocks}, {g.shape[1]}], hop {hop}), "
        f"median of {GEOMETRY_TIMES[0]} x {GEOMETRY_TIMES[1]} calls: kernel {k2[0]:.4f} ms, "
        f"plain {k2[1]:.4f} ms, library unfold @ g {k2[2]:.4f} ms, bound {k2_least[0]:.4f} ms "
        f"({k2_least[1]}); {tiling_of(xin, g, w_len, overlap, blocks)}; phase "
        f"{time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    short = short_channel_times(card_line)
    long = long_channel_times(card_line)
    return {"worst": worst, "k2": k2_worst, "times": times, "k2_times": (k2, k2_least),
            "short": short, "long": long, "band_launches": band_launches,
            "wire_equal": {w: layouts[f"wire bit equal {w}"] for w in ("int16", "mulaw8")}}


def long_channel_times(card_line: str) -> dict:
    """K2 on one 60 s channel at each of LONG_PAIRS: against its plain
    version (1e-4/1e-4, and with a NaN, an Inf and a -Inf in the samples,
    NaN and Inf in the same places), without a row split bit for bit the
    run form's result, and device ms of the kernel, its plain version and
    ``unfold @ g`` beside the bound and the launch; one line. Returns the
    kernel's launches here, its worst error and, per pair, (kernel, plain)
    ms, bound and library ms."""
    out, parts, launches, worst = {}, [], 0, 0.0
    for in_rate, out_rate in LONG_PAIRS:
        x = np.random.default_rng(6).uniform(
            -0.7, 0.7, int(CORPUS_SECONDS * in_rate)).astype(np.float32)
        xin, g, w_len, overlap, blocks, _ = resample.polyphase_framing(
            x, in_rate, out_rate, device="cuda")
        name = rate_name(in_rate, out_rate)
        cut = fg.launch_tiling(xin, g, w_len, overlap, blocks)
        if not cut.slots:
            raise AssertionError(f"K2 {name} on {CORPUS_SECONDS:g} s: not the slot form ({cut})")
        plain = fg.framed_gemm_reference(xin, g, w_len, overlap, blocks)
        before = fg.FRAMED_GEMM_LAUNCHES
        worst = max(worst, held(fg.framed_gemm(xin, g, w_len, overlap, blocks), plain, 1e-4,
                                1e-4, f"K2 {name}"))
        bad = xin.clone()
        for at, v in zip((xin.numel() // 7, xin.numel() // 2, xin.numel() - w_len // 2),
                         (float("nan"), float("inf"), float("-inf"))):
            bad[at] = v
        a = fg.framed_gemm(bad, g, w_len, overlap, blocks)
        b = fg.framed_gemm_reference(bad, g, w_len, overlap, blocks)
        worst = max(worst, held(a, b, 1e-4, 1e-4, f"K2 {name} non-finite"))
        if not torch.equal(a.isinf(), b.isinf()) or not 0 < int(b.isnan().sum()) < b.numel() // 2:
            raise AssertionError(f"K2 {name}: Inf in other places, or no NaN")
        launches += fg.FRAMED_GEMM_LAUNCHES - before
        # without a row split the slot form sums the run form's rows in its order
        one = cut._replace(ksplit=1, threads=32 * (cut.threads // 32 // cut.ksplit))
        run = next(c for c in (fg._tiling(w_len, g.shape[1], hop_length(w_len, overlap), f)
                               for f in (fg.FRAMES_PER_THREAD, fg.NARROW_FRAMES)) if c)
        run = run._replace(ksplit=1, threads=32 * (run.threads // 32 // run.ksplit))
        if not torch.equal(fg._launch(xin, g, w_len, overlap, blocks, one),
                           fg._launch(xin, g, w_len, overlap, blocks, run)):
            raise AssertionError(f"K2 {name}: the slot form is not the run form's bit for bit")
        hop = hop_length(w_len, overlap)
        need = (blocks - 1) * hop + w_len
        xpad = torch.cat([xin, xin.new_zeros(max(0, need - xin.numel()))])[:need]
        ms = [event_ms(fn, samples=GEOMETRY_TIMES[0], batch=GEOMETRY_TIMES[1])[0] for fn in (
            lambda: fg.framed_gemm(xin, g, w_len, overlap, blocks),
            lambda: fg.framed_gemm_reference(xin, g, w_len, overlap, blocks),
            lambda: xpad.unfold(0, w_len, hop) @ g)]
        least = framed_bound(xin, g, blocks)
        out[name] = ((ms[0], ms[1]), least, ms[2])
        parts.append(f"{name} kernel {ms[0]:.4f} / plain {ms[1]:.4f} / unfold @ g {ms[2]:.4f} "
                     f"({ms[0] / ms[2]:.2f} x) / bound {least[0]:.4f} ms ({least[1]}, "
                     f"{least[0] / ms[0]:.0%} of it), {launch_of(xin, g, w_len, overlap, blocks)}")
    print(f"phase 22 times [{card_line}]: K2 on one {CORPUS_SECONDS:g} s channel, device ms, "
          f"median of {GEOMETRY_TIMES[0]} x {GEOMETRY_TIMES[1]} calls; each against its plain "
          f"version max_abs {worst:.3g} (1e-4/1e-4, with a NaN, an Inf and a -Inf NaN and Inf "
          f"in the same places) and, without a row split, bit for bit the run form: "
          + "; ".join(parts), flush=True)
    return {"launches": launches, "worst": worst, "times": out}


def short_channel_times(card_line: str) -> dict:
    """K2 on one SHORT_SECONDS channel at each of SHORT_PAIRS: device ms of
    the kernel, its plain version and ``unfold @ g`` beside the bound, and
    the launch it took; one line. Returns (kernel, plain) ms, bound and
    library ms per pair."""
    out, parts = {}, []
    for in_rate, out_rate in SHORT_PAIRS:
        x = np.random.default_rng(6).uniform(
            -0.7, 0.7, int(SHORT_SECONDS * in_rate)).astype(np.float32)
        xin, g, w_len, overlap, blocks, _ = resample.polyphase_framing(
            x, in_rate, out_rate, device="cuda")
        hop = hop_length(w_len, overlap)
        need = (blocks - 1) * hop + w_len
        xpad = torch.cat([xin, xin.new_zeros(max(0, need - xin.numel()))])[:need]
        held(fg.framed_gemm(xin, g, w_len, overlap, blocks),
             xpad.unfold(0, w_len, hop) @ g, 1e-4, 1e-4, f"K2 {rate_name(in_rate, out_rate)}")
        ms = [event_ms(fn, samples=GEOMETRY_TIMES[0], batch=4 * GEOMETRY_TIMES[1])[0] for fn in (
            lambda: fg.framed_gemm(xin, g, w_len, overlap, blocks),
            lambda: fg.framed_gemm_reference(xin, g, w_len, overlap, blocks),
            lambda: xpad.unfold(0, w_len, hop) @ g)]
        least = framed_bound(xin, g, blocks)
        name = rate_name(in_rate, out_rate)
        out[name] = ((ms[0], ms[1]), least, ms[2])
        parts.append(f"{name} kernel {ms[0]:.4f} / plain {ms[1]:.4f} / unfold @ g {ms[2]:.4f} "
                     f"({ms[0] / ms[2]:.2f} x) / bound {least[0]:.4f} ms ({least[1]}), "
                     f"{launch_of(xin, g, w_len, overlap, blocks)}")
    print(f"phase 22 times [{card_line}]: K2 on one {SHORT_SECONDS:g} s channel, device ms, "
          f"median of {GEOMETRY_TIMES[0]} x {4 * GEOMETRY_TIMES[1]} calls: " + "; ".join(parts),
          flush=True)
    return out


def phase_build() -> None:
    """Phase 2: build every kernel source at once and hold ptxas' report
    (see the note at the head of this file)."""
    names = ("fused_detector", "framed_gemm")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(_build.build, names))
    for name, (_, seconds, log) in zip(names, builds):
        kernels = ptxas_report(log)
        if not kernels or any(spill != 0 for _, _, spill in kernels):
            raise AssertionError(f"{name}.cu: ptxas reports spills or nothing: {log[-2000:]}")
        # cta_choice counts each instantiation's CTAs an SM by the registers
        # fused.KERNEL_REGISTERS gives its layout; the resident fp32 ones on
        # the CUDA cores keep two CTAs of 256 threads an SM
        fp32 = [regs for kernel, regs, _ in kernels if kernel.endswith("fp32 samples")]
        over = [(kernel, regs) for kernel, regs, _ in kernels
                if name == "fused_detector" and regs > fused.KERNEL_REGISTERS[register_key(kernel)]]
        # the framed GEMM's slot form counts CTAs an SM by
        # fg.SLOT_REGISTERS, one figure for each frames-a-lane instantiation
        slot_over = [(kernel, regs) for kernel, regs, _ in kernels
                     if (m := re.search(r"slot_kernelILb[01]ELi(\d)E", kernel))
                     and regs > fg.SLOT_REGISTERS[int(m.group(1))]]
        if name == "framed_gemm" and (slot_over or not any("slot_kernel" in k for k, _, _ in kernels)):
            raise AssertionError(f"framed_gemm.cu: slot form instantiations above "
                                 f"fg.SLOT_REGISTERS {fg.SLOT_REGISTERS}, or none: {slot_over}")
        if name == "fused_detector" and (len(fp32) != 3 or not all(
                104 <= r <= fused.KERNEL_REGISTERS["resident"] for r in fp32) or over):
            raise AssertionError(
                f"the resident fp32 instantiations use {fp32} registers (104-"
                f"{fused.KERNEL_REGISTERS['resident']}); above their layout's "
                f"fused.KERNEL_REGISTERS: {over}")
        print(
            f"phase 2 build: {name}.cu in {seconds:.2f} s; registers: "
            f"{'; '.join(f'{kernel} {regs}' for kernel, regs, _ in kernels)}; spill bytes 0 "
            f"over {len(kernels)} kernels ok",
            flush=True,
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    marks = [("start", time.perf_counter())]

    def mark(label: str) -> None:
        marks.append((label, time.perf_counter()))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the tuner's cache of this run only: every phase before 21 takes the
    # kernels' analytic launch shapes
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["SD_TUNE_CACHE"] = os.path.join(tune_dir, "tune.json")
    try:
        return run_phases(marks, mark)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run_phases(marks, mark) -> int:
    card_line = card()
    print(card_line, flush=True)
    print(
        f"phase 1 device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"card(s), torch {torch.__version__}, CUDA {torch.version.cuda} ok",
        flush=True,
    )

    phase_build()

    mark("1-2")
    max_abs_err = phase_kernel()
    mark("3")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main(tmp)
        mark("4")
        stream_times = phase_times(tmp, card_line)
        mark("5")

        # the live path's nets: one seeded net per lane, each threshold away
        # from every output on the audio, which lies on the int16 grid so
        # that the int16 wire carries it exactly
        audio = fixtures.chirp_audio(10.0, 41)
        audio = (np.rint(audio * 32767.0) / 32767.0).astype(np.float32)
        cfgs = [
            fixtures.pick_thresholds(fixtures.sample_geometry_config(1000 + lane), audio,
                                     device="cuda")
            for lane in range(LANES)
        ]
        pairs = [detector.detector_spec_from_config(c, "cuda") for c in cfgs]
        batch_err = phase_batch(pairs)
        mark("6")
        live = phase_live(tmp, cfgs, audio, card_line)
        mark("7")
        times = phase_live_times(cfgs, audio, card_line)
        print(
            f"phase 8 times [{card_line}]: the {LANES}-channel monitor run processed "
            f"{live['audio_per_wall']:.1f} audio seconds per wall second",
            flush=True,
        )
        mark("8")
        resample_err = phase_resample_kernel()
        mark("9")
        scan = phase_corpus(tmp)
        mark("10")
        resample_times, scan_k1e, scan_xs = phase_corpus_times(scan, card_line)
        mark("11")
        new_err = phase_tiers()
        mark("12")
        mesh_counts = phase_mesh(tmp, scan, scan_xs, card_line)
        mark("13")
        dist_wall = phase_dist_scan(tmp, scan)
        mark("14")
        new_times = phase_new_times(scan, scan_xs, scan_k1e, dist_wall, card_line)
        mark("15")
        trained = phase_train(tmp)
        mark("16")
        phase_train_times(trained, card_line)
        mark("17")
        capture = phase_capture(tmp, audio[: int(CAPTURE_SECONDS * NET_RATE)], card_line)
        mark("18")
        resilient = phase_resilient(cfgs, card_line)
        mark("19")
        shard = phase_shard(cfgs, audio, card_line)
        mark("20")
        tuned = phase_tune(tmp, card_line)
        mark("21")
    reset_counts()
    geometry = phase_geometry(card_line)
    sweep = {
        "K1a": fused.LAUNCHES, "K1e": fused.BATCH_LAUNCHES, "K2": fg.FRAMED_GEMM_LAUNCHES,
        "K1b": fused.FRAMES_LAUNCHES, "K1d": fused.GRID_LAUNCHES,
        **{f"K1f {wire}": count for wire, count in fused.PROGRAM_LAUNCHES.items()},
        **{f"K1c {tier}": count for tier, count in fused.TIER_LAUNCHES.items()},
    }
    if not all(sweep.values()):
        raise AssertionError(f"phase 22 launched an entry no time: {sweep}")
    if not all(fused.LAYOUT_LAUNCHES.values()):
        raise AssertionError(f"phase 22 took a layout no time: {fused.LAYOUT_LAUNCHES}")
    if not all(fg.LAUNCH_KINDS.values()):
        raise AssertionError(f"phase 22 took a framed GEMM launch no time: {fg.LAUNCH_KINDS}")
    if not (geometry["wire_equal"]["int16"] and geometry["wire_equal"]["mulaw8"]):
        raise AssertionError(f"phase 22 held no streamed K1f launch against K1e: "
                             f"{geometry['wire_equal']}")
    print(f"phase 22 launches: {sweep}; by layout {fused.LAYOUT_LAUNCHES}; K2 by launch "
          f"{fg.LAUNCH_KINDS} ok", flush=True)
    mark("22")
    print(
        "phase walls (host clock, each to its last line): "
        + ", ".join(f"{label} {t - prev:.1f} s"
                    for (_, prev), (label, t) in zip(marks, marks[1:]))
        + f"; all {marks[-1][1] - marks[0][1]:.1f} s",
        flush=True,
    )

    def entry(name, source, replaces, launches, err, ms, least, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1],
                "bound_ms": least[0], "bound_by": least[1], "library_ms": library_ms}

    n = live["launches"]
    band_launches = geometry["band_launches"]
    kernel, plain, library, least = resample_times[48000]
    worst = geometry["worst"]
    print(json.dumps({"kernels": [
        entry("fused_detector", KERNEL_SOURCE, REPLACES, launches + sweep["K1a"],
              max(max_abs_err, worst["K1a"]), stream_times, stream_times[2]),
        entry("fused_detector_batch", KERNEL_SOURCE, REPLACES_FLAT, n["float32"] + sweep["K1e"],
              max(batch_err["float32"], worst["K1e shared"], worst["K1e per-lane"]),
              times["float32"], times["float32"][2]),
        entry("fused_detector_batch corpus", KERNEL_SOURCE, REPLACES_FLAT, scan["k1e"],
              scan_k1e[3], scan_k1e[:2], scan_k1e[2]),
        *(entry(f"fused_batch_program {wire}", KERNEL_SOURCE, REPLACES_PROGRAM,
                n[wire] + sweep[f"K1f {wire}"], max(batch_err[wire], worst[f"K1f {wire}"]),
                times[wire], times[wire][2])
          for wire in ("int16", "mulaw8")),
        entry("framed_gemm", FRAMED_SOURCE, REPLACES_FRAMED, scan["k2"] + sweep["K2"],
              max(resample_err, geometry["k2"]), (kernel[0], plain[0]), least, library[0]),
        entry("framed_gemm band launch 48k->11.025k 5 s", FRAMED_SOURCE, REPLACES_FRAMED,
              band_launches, geometry["k2"], *geometry["short"]["48k->11.025k"]),
        entry("framed_gemm long launch slots 192k->11.025k 60 s", FRAMED_SOURCE,
              REPLACES_FRAMED, geometry["long"]["launches"], geometry["long"]["worst"],
              *geometry["long"]["times"]["192k->11.025k"]),
        entry("fused_detector_frames", KERNEL_SOURCE, REPLACES_FRAMES,
              mesh_counts["frames"] + sweep["K1b"], max(new_err["frames"], worst["K1b"]),
              new_times["frames"], new_times["frames"][2]),
        *(entry(f"fused_detector_tiers {tier}", KERNEL_SOURCE, REPLACES_TIERS,
                mesh_counts["tiers"][tier] + sweep[f"K1c {tier}"],
                max(new_err[tier], worst[f"K1c {tier}"]), new_times[tier], new_times[tier][2])
          for tier in fused.TIERS),
        entry("fused_detector_grid corpus", KERNEL_SOURCE, REPLACES_SLABBED,
              mesh_counts["grid"] + sweep["K1d"], max(new_err["grid"], worst["K1d"]),
              new_times["grid"], new_times["grid"][2]),
        # the capture path launches K1f at phase 6's and 8's shape: [256,
        # bucket_samples(128)] int16 with the same per-lane nets
        entry("fused_batch_program int16 capture", KERNEL_SOURCE, REPLACES_PROGRAM,
              capture["alsa"], batch_err["int16"], times["int16"], times["int16"][2]),
        *(entry(f"fused_batch_program int16 sharded {w} workers", KERNEL_SOURCE,
                REPLACES_PROGRAM, shard[w], *shard[w, "kernel"])
          for w in SHARD_WORKERS),
        *(entry(f"{'fused_detector' if w == 'single' else 'fused_detector_batch'} tuned {w}",
                KERNEL_SOURCE, REPLACES if w == "single" else REPLACES_FLAT, t[0], t[1],
                (t[2], t[3]), t[4])
          for w, t in tuned.items()),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
