"""The plain reference against the port's plain CPU path at tiny sizes: a
live round of the bank, a corpus scan's outputs through the resampler, and
the training features, labels and first steps."""

import numpy as np
import torch

from benchmark import harness, program, synth
from benchmark.reference import detect
from benchmark.reference import train as ref_train

GEOM = harness.load_json("configs", "sample_44k")


def test_live_round_matches_the_bank():
    from syllable_detector_tpu_torch.models.detector_bank import DetectorBank

    gen = synth.generator(2**31 + 11, "cpu")
    xs = [synth.chirp(20000, 44100, gen, "cpu") for _ in range(3)]
    nets = [synth.net(GEOM, gen, "cpu") for _ in range(3)]
    bank = DetectorBank([program.port_config(GEOM, n, 0.5) for n in nets], method="matmul",
                        transfer_dtype="int16", device="cpu")
    codes = [synth.to_s16(x, 32767.0) for x in xs]
    for j, c in enumerate(codes):
        bank.append_audio_data(j, (c.to(torch.float64) / 32767.0).to(torch.float32).numpy())
    out = bank.drain(flush=True)
    for j, c in enumerate(codes):
        want = detect.outputs(GEOM, nets[j], c.to(torch.float64) / 32767.0).numpy()
        got = out[j, : bank.last_counts[j], 0]
        assert len(got) == len(want) == (20000 - 256) // 132 + 1 - 9
        np.testing.assert_array_equal(bank.last_sample_indices[j], 1444 + 132 * np.arange(141))
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=2e-5)


def test_resampled_scan_matches_the_port():
    from syllable_detector_tpu_torch.corpus import resample_channels, scan_corpus

    gen = synth.generator(2**31 + 12, "cpu")
    net = synth.net(GEOM, gen, "cpu")
    cfg = program.port_config(GEOM, net, 0.5)
    for rate in (48000.0, 96000.0, 32000.0):
        x = synth.to_s16(synth.chirp(int(0.5 * rate), rate, gen, "cpu"), 32768.0)
        x = x.to(torch.float64) / 32768.0
        got_x = resample_channels(x.to(torch.float32).numpy()[:, None], rate, 44100.0, "cpu")[:, 0]
        want_x = detect.resample(x, rate, 44100.0).numpy()
        assert len(got_x) == len(want_x)
        np.testing.assert_allclose(got_x, want_x, rtol=0, atol=2e-6)
        got = scan_corpus(cfg, [got_x], method="matmul", device="cpu")[0][:, 0]
        want = detect.outputs(GEOM, net, torch.from_numpy(want_x)).numpy()
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=2e-5)


def test_training_features_labels_and_first_steps_match_the_port():
    from syllable_detector_tpu_torch.training import trainer

    audio, intervals = synth.labeled_audio(3.0, 44100, 2**31 + 13)
    settings = trainer.TrainSettings(learning_rate=3e-3, epochs=1, batch_size=256,
                                     seed=2**31 + 13)
    feats, labels = trainer.features_and_labels(settings, audio, intervals, "cpu")
    ref = ref_train.Trainer(GEOM, audio, intervals, 2**31 + 13, "cpu")
    np.testing.assert_array_equal(ref.labels.numpy(), labels)
    np.testing.assert_allclose(ref.feats.numpy(), feats, rtol=1e-5, atol=1e-7)
    specs, _ = trainer.fit_input_chain(settings, feats, "cpu")
    np.testing.assert_allclose(ref.x_offsets.numpy(), specs[1].x_offsets, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ref.gains.numpy(), specs[1].gains, rtol=1e-5)
    losses = ref.run(1, 3e-3)
    seen = []
    loop = trainer._run_training_loop

    def spy(settings, epoch_fn, *rest):
        def epochs(*args):
            out = epoch_fn(*args)
            seen.append(out[-1].numpy())
            return out
        return loop(settings, epochs, *rest)

    trainer._run_training_loop = spy
    try:
        trainer.train(settings, feats, labels, device="cpu")
    finally:
        trainer._run_training_loop = loop
    np.testing.assert_allclose(np.concatenate(seen), losses, rtol=1e-5)
