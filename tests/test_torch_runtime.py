"""The port's live runtime against the JAX package's: the linear resampler,
and the Processor per lane and batched on the simulated capture device.

Both Processors see the same seeded audio, distinct nets, one capture gap
and one resampled lane (a lane told that the device runs at 48 kHz, for a
44.1 kHz net). The audio is shorter than the rings, so no overflow makes
the result depend on the worker's timing. Event-log columns 1-3 must be
identical and outputs within rtol=1e-3, atol=2e-4; detection counts and
gap counters must be equal.
"""

import io

import numpy as np
import pytest
import torch

from syllable_detector_tpu.ops import resample as jresample
from syllable_detector_tpu.runtime import audio_io as jaudio
from syllable_detector_tpu.runtime import processor as jproc
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.ops import resample as tresample
from syllable_detector_tpu_torch.runtime import audio_io as taudio
from syllable_detector_tpu_torch.runtime import processor as tproc

torch.set_num_threads(1)

RATE = 44100
FRAME = 1320  # ten hops per capture callback
GAP_AT = 15 * FRAME  # stream position of the capture gap (a whole hop count)
GAP_FRAMES = 500
SEEDS = (21, 22, 23, 24)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rates", [(48000.0, 44100.0), (44100.0, 48000.0), (44100.0, 44099.5)])
def test_linear_resampler_bit_equal_to_jax(seed, rates):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(20000).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, len(x)), size=40, replace=False))
    chunks = np.split(x, cuts)
    for chunk_fn in ("linear_resample_chunk", "linear_resample_chunk_exact"):
        ts = tresample.linear_resample_init(*rates)
        js = jresample.linear_resample_init(*rates)
        for chunk in chunks + [x[:1], x[:0]]:
            got, ts = getattr(tresample, chunk_fn)(chunk, ts)
            want, js = getattr(jresample, chunk_fn)(chunk, js)
            np.testing.assert_array_equal(got, want)
            assert (ts.step, ts.last, ts.offset, ts.step64) == (
                js.step, js.last, js.offset, js.step64
            )
    np.testing.assert_array_equal(
        tresample.linear_resample(x, *rates), jresample.linear_resample(x, *rates)
    )


@pytest.fixture(scope="module")
def lanes():
    """(audio, config) per lane: distinct nets, thresholds away from every
    output on the audio each lane's detector will see."""
    audio = [fixtures.chirp_audio(1.0, seed) for seed in SEEDS]
    cfgs = []
    for i, (seed, a) in enumerate(zip(SEEDS, audio)):
        seen = a
        if i == 3:  # the resampled lane
            state = tresample.linear_resample_init(48000.0, RATE)
            seen, _ = tresample.linear_resample_chunk_exact(a, state)
        cfgs.append(fixtures.pick_thresholds(fixtures.sample_geometry_config(seed), seen))
    return audio, cfgs


def run_processor(pkg, lanes, **kw):
    """One non-realtime session of ``pkg``'s Processor on its simulated
    device: (sorted event rows, lane_detections, lane_stats)."""
    audio, cfgs = lanes
    sim_in, sim_out = (
        (taudio.SimulatedAudioInput, taudio.SimulatedAudioOutput)
        if pkg is tproc
        else (jaudio.SimulatedAudioInput, jaudio.SimulatedAudioOutput)
    )
    holder = {}

    def source(ch, start, n):
        if ch == 0 and start == GAP_AT:
            # the device lost frames just before this block
            holder["proc"].receive_capture_gap(holder["interface"], GAP_FRAMES)
        return audio[ch][start : start + n]

    interface = sim_in(
        source, channels=len(cfgs), sample_rate=float(RATE), frame_size=FRAME,
        total_samples=len(audio[0]),
    )
    entries = [
        pkg.ProcessorEntry(i, i, config=c, resample_from=48000.0 if i == 3 else None)
        for i, c in enumerate(cfgs)
    ]
    log = io.StringIO()
    proc = pkg.Processor(
        interface, entries, pkg.AudioTTLOutput(sim_out(channels=len(cfgs))),
        event_log=pkg.csv_event_log(log), **kw,
    )
    holder.update(proc=proc, interface=interface)
    proc.set_up()
    assert interface.wait_until_done(timeout=60)
    proc.drain_pending(timeout=60)
    proc.tear_down()
    assert proc.drain_errors == 0 and proc.output_errors == 0
    rows = sorted(
        (line.split(",") for line in log.getvalue().splitlines()),
        key=lambda r: (int(r[0]), int(r[1])),
    )
    return rows, proc.lane_detections(), proc.lane_stats()


def compare(got, want):
    g_rows, g_det, g_stats = got
    w_rows, w_det, w_stats = want
    assert [r[:3] for r in g_rows] == [r[:3] for r in w_rows]
    np.testing.assert_allclose(
        np.array([r[3:] for r in g_rows], np.float64),
        np.array([r[3:] for r in w_rows], np.float64),
        rtol=1e-3, atol=2e-4,
    )
    assert g_det == w_det
    keys = ("input_channel", "detections", "overflows", "dropped_samples",
            "capture_gaps", "capture_lost_samples")
    assert [[s[k] for k in keys] for s in g_stats] == [[s[k] for k in keys] for s in w_stats]


MODES = {
    "per-lane": {},
    "batched-float32": {"batched": True},
    "batched-int16": {"batched": True, "bank_transfer_dtype": "int16"},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_processor_matches_jax(lanes, mode):
    kw = MODES[mode]
    got = run_processor(tproc, lanes, device="cpu", **kw)
    want = run_processor(jproc, lanes, **kw)
    compare(got, want)
    rows, detections, stats = got
    assert all(d > 0 for d in detections) and len(rows) == sum(detections)
    # the gap is spliced in at its place on every lane, resampled or not
    assert [s["capture_gaps"] for s in stats] == [1] * 4
    assert [s["capture_lost_samples"] for s in stats] == [500, 500, 500, 459]
    # no event inside the lost stretch's re-warm-up on lane 0
    samples = [int(r[1]) for r in rows if r[0] == "0"]
    first_after = GAP_AT + GAP_FRAMES + 1444
    assert not [s for s in samples if GAP_AT + 1 <= s < first_after]


def test_per_lane_and_batched_agree(lanes):
    per_lane = run_processor(tproc, lanes, device="cpu")
    batched = run_processor(tproc, lanes, device="cpu", batched=True, method="matmul")
    compare(batched, per_lane)


def test_receive_audio_per_channel_and_stats(lanes):
    """The per-channel delivery path (no block delegate) gives the same
    detections as the block path, and the level stats read back."""
    audio, cfgs = lanes
    entries = [tproc.ProcessorEntry(i, i, config=c) for i, c in enumerate(cfgs[:2])]
    seen = []
    proc = tproc.Processor(
        taudio.SimulatedAudioInput(lambda c, s, n: audio[c][s : s + n], channels=2),
        entries, tproc.CallbackOutput(lambda i, e, s: seen.append((i, s))),
        device="cpu", batched=True,
    )
    for start in range(0, len(audio[0]), 4000):
        for ch in range(2):
            proc.receive_audio(None, ch, audio[ch][start : start + 4000])
        proc._drain_all()
    proc.receive_audio(None, 7, audio[0][:10])  # no lane: ignored
    assert proc.get_input_for_channel(0) > 0.0 and proc.get_input_for_channel(9) is None
    assert proc.get_output_for_channel(1) is not None
    assert proc.lane_detections()[0] > 0 and any(s for _, s in seen)
    assert proc.warm_up(buckets=(8,)) == 1


def test_cuda_device_without_card_raises(lanes):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cfgs = lanes
    entries = [tproc.ProcessorEntry(0, 0, config=cfgs[0])]
    for batched in (False, True):
        with pytest.raises((RuntimeError, AssertionError)):
            tproc.Processor(
                taudio.SimulatedAudioInput(lambda c, s, n: np.zeros(n, np.float32)),
                entries, tproc.CallbackOutput(lambda *a: None), batched=batched,
            )
