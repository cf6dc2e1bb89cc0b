"""On the card: a span of the port's ring around a kernel and the wait for it
contains that kernel's interval as ``trace.DeviceTrace`` maps device events
onto the host's ``perf_counter``; prints the margins on either side."""

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("cycles", [10**6, 5 * 10**7])
def test_a_program_span_contains_the_kernel_it_waits_for(cycles):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from benchmark.trace import DeviceTrace, warm_profiler
    from syllable_detector_tpu_torch.utils import timing

    warm_profiler()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with DeviceTrace() as trace:
        with timing.span("clock.check") as s:
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
    span, = [r for r in timing.spans() if r.id == s.id]
    name, a, b = max(trace.events, key=lambda e: e[2] - e[1])
    lo, hi = span.start_ns / 1e9, span.end_ns / 1e9
    print(f"clock: {name} {1e3 * (b - a):.4f} ms in a span of {1e3 * (hi - lo):.4f} ms; "
          f"launch margin {1e6 * (a - lo):.1f} us, wait margin {1e6 * (hi - b):.1f} us")
    assert lo <= a < b <= hi
