"""The gradient exchange between cards of the data-parallel trainer's epoch
graph: an all-gather of every shard's row (its losses, then its
gradients), inside each card's CUDA graph.

Not a port of a TPU kernel: the JAX trainer reaches no ``pl.pallas_call``.
It takes the place of the ``lax.pmean`` inside the JAX trainer's
``shard_map`` (``syllable_detector_tpu/training/trainer.py``,
``_make_restart_epoch``). The design, the slots by step parity and the
timeout are in the note at the head of ``csrc/peer_exchange.cu``.

Each card ``c`` holds ``slots[c]`` ``[2, shards, width]`` float32 (two
slots by step parity), ``flags[c]`` ``[cards]`` int64 (one a source card,
the last step + 1 whose rows have landed), a step base ``[1]`` int64 and an
error word ``[1]`` int32. The step of a call is the base's value plus
``offset``, so a captured graph runs every epoch's steps from a base that
the host sets and the graph advances.

:func:`push` stores a card's rows into every card's slot and raises its
flags; :func:`wait` waits for every source's flag on its card and copies
the step's slot out; :func:`check` raises where a wait timed out. On CUDA
tensors they launch the kernels of ``csrc/peer_exchange.cu`` or raise; on
CPU tensors they run the plain versions, :func:`push_reference` and
:func:`wait_reference`, which only the tests reach (the trainer's route on
the CPU is its per-step loop). Launches are counted in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "LAUNCHES",
    "MAX_CARDS",
    "TIMEOUT_NS",
    "check",
    "enable_peers",
    "push",
    "push_reference",
    "wait",
    "wait_reference",
]

# Kernel launches in this process, by kernel; reset to 0 before a run whose
# launches are to be counted. A launch captured in a CUDA graph counts once,
# at its capture; its replays are counted by the graph's owner.
LAUNCHES = {"push": 0, "wait": 0}
# The cards one exchange spans at most (the kernel's table of peer pointers).
MAX_CARDS = 8
# A wait gives up after this many ns of %globaltimer: far beyond a step's
# microseconds and a graph launch's milliseconds, far below a run's limit.
TIMEOUT_NS = 10_000_000_000


def enable_peers(devices) -> None:
    """Let each card of ``devices`` read and write every other's memory;
    raise where a pair cannot (nothing falls back to host copies). Does
    nothing for a CPU device."""
    cards = sorted({d.index for d in map(torch.device, devices) if d.type == "cuda"})
    if not cards:
        return
    if len(cards) > MAX_CARDS:
        raise ValueError(f"the exchange spans at most {MAX_CARDS} cards, not {len(cards)}")
    lib = _library()
    for a in cards:
        for b in cards:
            if a == b:
                continue
            here = torch.device("cuda", a)
            # as every library call of the kernels: under the card it acts on
            with torch.cuda.device(here):
                err = lib.sd_peer_enable(a, b)
            if err != 0:
                raise RuntimeError(
                    f"cuda:{a} cannot reach cuda:{b}'s memory: "
                    f"{lib.sd_peer_exchange_error_string(err).decode()} (cudaError {err})")


def push_reference(rows, shard_of, slots, flags, source: int, base, offset: int) -> None:
    """The push's plain version: ``rows`` into the rows ``shard_of`` of the
    step's slot of every card's buffer, then this ``source``'s flag of
    every card set to the step + 1."""
    step = int(base) + offset
    for slot, flag in zip(slots, flags, strict=True):
        slot[step % 2].index_copy_(0, shard_of.to(slot.device, torch.long), rows.to(slot.device))
        flag[source] = step + 1


def push(rows, shard_of, slots, flags, source: int, base, offset: int) -> None:
    """Card ``source``'s rows ``[n, width]`` float32 (shards ``shard_of``
    ``[n]`` int32) into the step's slot of each of ``slots`` (every card's
    ``[2, shards, width]``, card by card), then its flag in each of
    ``flags`` (every card's ``[cards]`` int64) set to the step + 1; the
    step is ``base`` (``[1]`` int64) + ``offset``. ``rows``, ``shard_of``
    and ``base`` lie on card ``source``; on the CPU the plain version."""
    if rows.device.type == "cpu":
        push_reference(rows, shard_of, slots, flags, source, base, offset)
        return
    _check_push(rows, shard_of, slots, flags, source, base, offset)
    lib = _library()
    cards = len(slots)
    slot_ptrs = (ctypes.c_void_p * cards)(*(s.data_ptr() for s in slots))
    flag_ptrs = (ctypes.c_void_p * cards)(*(f.data_ptr() for f in flags))
    # as every library call of the kernels: under its tensors' card
    with torch.cuda.device(rows.device):
        err = lib.sd_peer_push(
            rows.data_ptr(), shard_of.data_ptr(), rows.shape[0], slots[0].shape[1],
            rows.shape[1], slot_ptrs, flag_ptrs, cards, source, base.data_ptr(), offset,
            rows.device.index, torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on(lib, err, "push")
    LAUNCHES["push"] += 1


def wait_reference(flags, slots, ready, base, offset: int) -> None:
    """The wait's plain version: raise unless every source's flag has
    reached the step, then the step's slot of ``slots`` into ``ready``."""
    step = int(base) + offset
    late = (flags <= step).nonzero().flatten().tolist()
    if late:
        raise RuntimeError(f"step {step}: the rows of card(s) {late} have not landed")
    ready.copy_(slots[step % 2])


def wait(flags, slots, ready, base, offset: int, error, timeout_ns: int = TIMEOUT_NS) -> None:
    """Wait until every source's flag in ``flags`` (``[cards]`` int64)
    exceeds the step (``base`` + ``offset``), then copy the step's slot of
    this card's ``slots`` (``[2, shards, width]``) into ``ready`` (``[shards,
    width]``). On a card a wait past ``timeout_ns`` sets ``error`` (``[1]``
    int32), which :func:`check` reads; on the CPU the plain version, which
    raises at once."""
    if flags.device.type == "cpu":
        wait_reference(flags, slots, ready, base, offset)
        return
    _check_wait(flags, slots, ready, base, offset, error, timeout_ns)
    lib = _library()
    # as every library call of the kernels: under its tensors' card
    with torch.cuda.device(flags.device):
        err = lib.sd_peer_wait(
            flags.data_ptr(), flags.shape[0], slots.data_ptr(), ready.data_ptr(), ready.numel(),
            base.data_ptr(), offset, error.data_ptr(), timeout_ns, flags.device.index,
            torch.cuda.current_stream(flags.device).cuda_stream)
    _raise_on(lib, err, "wait")
    LAUNCHES["wait"] += 1


def check(errors) -> None:
    """Raise where a wait timed out: each of ``errors`` (a card's error
    word) holds 0, or the late source card + 1. Reads every word, so it
    waits for each card's work before it."""
    words = [(e.device, int(e.item())) for e in errors]
    late = [(dev, word - 1) for dev, word in words if word]
    if late:
        raise RuntimeError(
            "the gradient exchange timed out: "
            + ", ".join(f"{dev} waited for card {src}'s rows" for dev, src in late))


def _raise_on(lib, err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"peer exchange {kernel} launch failed: "
                           f"{lib.sd_peer_exchange_error_string(err).decode()} (cudaError {err})")


def _is(t, dtype, shape, device, what: str) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"the peer exchange takes {what} as contiguous {dtype} of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} of shape "
                         f"{tuple(t.shape)} on {t.device}")


def _hopper(device: torch.device) -> None:
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the peer exchange kernels are built for sm_90a (Hopper); "
                           f"{torch.cuda.get_device_name(device)} is not")


def _check_push(rows, shard_of, slots, flags, source, base, offset) -> None:
    """Raise unless the push's tensors are what its kernel takes: each
    card's slots and flags on that card (several cards' buffers may share
    one), the source's own tensors on its card."""
    cards = len(slots)
    if not 0 < cards <= MAX_CARDS or len(flags) != cards or not 0 <= source < cards:
        raise ValueError(f"{cards} slots, {len(flags)} flags and source {source}: the exchange "
                         f"takes one slot and one flag tensor a card, 1 to {MAX_CARDS} cards")
    devices = [s.device for s in slots]
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"the slots lie on {devices}, not on cards")
    if rows.dim() != 2 or offset < 0:
        raise ValueError(f"rows of shape {tuple(rows.shape)}, offset {offset}")
    n, width = rows.shape
    shards = slots[0].shape[1] if slots[0].dim() == 3 else 0
    if not 0 < n <= shards:
        raise ValueError(f"{n} rows for {shards} shards")
    dev = devices[source]
    _is(rows, torch.float32, (n, width), dev, "rows")
    _is(shard_of, torch.int32, (n,), dev, "shard_of")
    _is(base, torch.int64, (1,), dev, "the step base")
    for s, f, d in zip(slots, flags, devices):
        _is(s, torch.float32, (2, shards, width), d, "each card's slots")
        _is(f, torch.int64, (cards,), d, "each card's flags")
    _hopper(dev)


def _check_wait(flags, slots, ready, base, offset, error, timeout_ns) -> None:
    """Raise unless the wait's tensors are what its kernel takes, all on
    one card."""
    dev = flags.device
    if flags.dim() != 1 or not 0 < flags.shape[0] <= MAX_CARDS or offset < 0 or timeout_ns < 0:
        raise ValueError(f"flags of shape {tuple(flags.shape)}, offset {offset}, "
                         f"timeout {timeout_ns} ns")
    _is(flags, torch.int64, flags.shape, dev, "flags")
    _is(slots, torch.float32, (2, *ready.shape), dev, "slots")
    _is(ready, torch.float32, ready.shape, dev, "ready")
    _is(base, torch.int64, (1,), dev, "the step base")
    _is(error, torch.int32, (1,), dev, "the error word")
    if ready.numel() >= 2**31:
        raise ValueError(f"{ready.numel()} floats a slot is beyond the kernel's int count")
    _hopper(dev)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound kernel library (built at the first launch)."""
    from syllable_detector_tpu_torch.kernels import _build

    lib = _build.load("peer_exchange")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
    lib.sd_peer_enable.argtypes = [i, i]
    lib.sd_peer_enable.restype = i
    lib.sd_peer_push.argtypes = [p, p, i, i, i, pp, pp, i, i, p, i, i, p]
    lib.sd_peer_push.restype = i
    lib.sd_peer_wait.argtypes = [p, i, p, p, i, p, i, p, ll, i, p]
    lib.sd_peer_wait.restype = i
    lib.sd_peer_exchange_error_string.argtypes = [i]
    lib.sd_peer_exchange_error_string.restype = ctypes.c_char_p
    if lib.sd_peer_max_cards() != MAX_CARDS:
        raise RuntimeError("csrc/peer_exchange.cu and kernels/peer_exchange.py disagree on "
                           "the most cards")
    return lib
