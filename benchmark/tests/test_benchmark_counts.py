"""The frozen operation and byte counts against hand counts at the sample
geometry (44.1 kHz, FFT and window 256, hop 132, bins [12, 41), timeRange
10, 290 -> 4 -> 1)."""

import pytest

from benchmark import harness, roofline
from benchmark.reference import detect

GEOM = harness.load_json("configs", "sample_44k")


def test_geometry():
    assert roofline.bins(GEOM) == (12, 41)
    assert roofline.hop(GEOM) == 132
    assert roofline.layer_sizes(GEOM) == [(290, 4), (4, 1)]
    assert detect.first_output_sample(GEOM) == 1444


def test_detect_flops_by_hand():
    # one lane of 60 s: 20044 frames, 20035 evaluations
    n = 60 * 44100
    frames = roofline.num_frames(n, GEOM)
    assert frames == 1 + (n - 256) // 132 == 20044
    per_frame = 4 * 256 * 29 + 5 * 29
    per_eval = 2 * 290 * 4 + 2 * 4 * 1
    assert roofline.detect_flops(GEOM, frames, frames - 9) == frames * per_frame + (frames - 9) * per_eval


def test_fused_bound_by_hand():
    n = 60 * 44100
    frames, evals = 20044, 20035
    flops = 2 * (frames * (4 * 256 * 29 + 5 * 29) + evals * (2 * 290 * 4 + 8))
    operands = 2 * 256 * 29 + (290 * 4 + 4) + (4 + 1)
    nbytes = 2 * (n * 4 + evals * 4) + operands * 4
    want = max(flops / 67e12, nbytes / 3.35e12)
    assert roofline.fused_bound(GEOM, [n, n], 4, 1) == pytest.approx(want, rel=1e-12)
    # operations bound it at this geometry
    assert flops / 67e12 > nbytes / 3.35e12


def test_framed_bound_by_hand():
    # 48 kHz -> 44.1 kHz: 147 / 160, a 3201-tap filter
    up, down, h = detect.plan(48000, 44100)
    assert (up, down, len(h)) == (147, 160, 3201)
    n = 60 * 48000
    x_numel, g_numel, nnz, up_, frames = detect.framed_shape(n, up, down, h)
    assert up_ == 147 and frames == -(-(-(-n * 147 // 160)) // 147)
    assert nnz == 3201  # the sinc's zeros at multiples of 160 are rounding, not 0
    want = max(2 * frames * nnz / 67e12, 4 * (x_numel + g_numel + frames * 147) / 3.35e12)
    assert roofline.framed_bound(x_numel, g_numel, nnz, up, frames) == want


def test_train_step_flops_by_hand():
    # a batch of 256 rows, 4 stacked nets: forward 2*(290*4 + 4*1), the
    # weights' gradients the same, the hidden layer's input gradient 2*4*1
    per_row = 2 * (290 * 4 + 4) + 2 * (290 * 4 + 4) + 2 * 4
    assert roofline.train_step_flops(GEOM, 256, 4) == 256 * 4 * per_row
