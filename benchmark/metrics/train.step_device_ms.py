"""Device milliseconds an optimizer step: the device's busy time inside the
trainer's epoch loop of the traced run over the steps it ran
(``torch.profiler``; the steps counted by a wrapper around the loop's epoch
function)."""


def read(run):
    t, steps = run.device_trace, run.work.get("traced_steps")
    if t is None or not steps or not t.events:
        return None
    busy = sum(t.busy_s(a, b) for a, b in run.spans.intervals.get("trainer.epochs", ()))
    return 1e3 * busy / steps if busy else None
