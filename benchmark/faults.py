"""Faults planted underneath the timed path, for the check that ``correct``
comes out false when the program is wrong (``tests/test_benchmark_faults.py``,
``control.py --mode fault:<name>``). Each is a context manager that patches
one function of the port where it produces its answers and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, attr: str, make):
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def _bank():
    from syllable_detector_tpu_torch.models.detector_bank import DetectorBank

    return DetectorBank


def live_unchanged():
    """Every round of the bank returns the first round's outputs of its
    shape: the stream's state never advances."""
    def make(original):
        first = {}

        def wire(self, xs):
            out = original(self, xs)
            return first.setdefault(out.shape, out.copy()).copy()
        return wire
    return patched(_bank(), "_wire_outputs", make)


def live_half_lanes():
    """The second half of the lanes is left out of every round (zeros)."""
    def make(original):
        def wire(self, xs):
            out = original(self, xs)
            out[out.shape[0] // 2 :] = 0.0
            return out
        return wire
    return patched(_bank(), "_wire_outputs", make)


def live_altered():
    """One output of lane 0, in the first round after the 20th that gives it
    one, is altered by 0.01 as the bank returns it."""
    def make(original):
        calls = [0]

        def drain(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            calls[0] += 1
            if calls[0] >= 20 and self.last_counts[0]:
                out[0, 0, 0] += 0.01
                calls[0] = -(1 << 62)  # once
            return out
        return drain
    return patched(_bank(), "drain", make)


def _corpus():
    from syllable_detector_tpu_torch import corpus

    return corpus


def corpus_half_lanes():
    """The scan leaves out the second half of its lanes (zeros)."""
    def make(original):
        def outputs(spec, params, xs, method="matmul"):
            out = original(spec, params, xs, method)
            out[out.shape[0] // 2 :] = 0.0
            return out
        return outputs
    return patched(_corpus(), "batch_offline_outputs_shared", make)


def corpus_altered():
    """The largest output of every scan's first lane is altered by 0.01."""
    def make(original):
        def outputs(spec, params, xs, method="matmul"):
            out = original(spec, params, xs, method)
            row = out[0, :, 0].nan_to_num(nan=-1e30).argmax()
            out[0, row, 0] += 0.01
            return out
        return outputs
    return patched(_corpus(), "batch_offline_outputs_shared", make)


def _trainer():
    from syllable_detector_tpu_torch.training import trainer

    return trainer


def train_unchanged():
    """Each optimizer step returns its losses and leaves the state as it was."""
    def make(original):
        def step(net_spec, lr, params, opt_state, feats, labels):
            return _trainer()._batch_grads(net_spec, params, feats, labels)[0]
        return step
    return patched(_trainer(), "_stacked_step", make)


def train_half_batch():
    """Each optimizer step takes the first half of its batch, the mean over it."""
    def make(original):
        def step(net_spec, lr, params, opt_state, feats, labels):
            half = len(feats) // 2
            return original(net_spec, lr, params, opt_state, feats[:half], labels[:half])
        return step
    return patched(_trainer(), "_stacked_step", make)


def train_stale_rows():
    """Every epoch after the first trains on the first epoch's batch rows,
    as a replay whose index rows were not refilled would."""
    def make(original):
        def loop(settings, epoch_fn, data, epoch_indices, *rest):
            first = []

            def indices():
                rows = epoch_indices()
                if not first:
                    first.append(rows)
                return first[0]
            return original(settings, epoch_fn, data, indices, *rest)
        return loop
    return patched(_trainer(), "_run_training_loop", make)


FAULTS = {
    "live": {"unchanged": live_unchanged, "half_lanes": live_half_lanes,
             "altered": live_altered},
    "corpus": {"half_lanes": corpus_half_lanes, "altered": corpus_altered},
    "train": {"unchanged": train_unchanged, "half_batch": train_half_batch,
              "stale_rows": train_stale_rows},
}
