"""Framed GEMM: ``frames(x) @ G`` with the frames built on the card.

Replaces the JAX package's Pallas kernel (``kernels/framed_gemm.py``,
``framed_gemm``), which the polyphase resampler runs on: frame k of ``x``
is ``x[gap + k*hop : gap + k*hop + window]``, zero-padded past the end,
and the result is the ``[n_frames, window] @ [window, m]`` product without
the frame matrix ever being written to device memory. ``gap`` and ``hop``
come from ``window_overlap`` as in ``ops.stft`` (a negative overlap is a
gap before every frame).

:func:`framed_gemm` launches the kernel of ``csrc/framed_gemm.cu`` for a
CUDA tensor, raising rather than falling back, and runs the plain PyTorch
version, :func:`framed_gemm_reference`, for a CPU tensor. Launches are
counted in :data:`FRAMED_GEMM_LAUNCHES`.

The kernel skips G's zeros. The resampler's G is banded, so for each tile
of neighbouring columns only a short range of rows holds a non-zero.
:func:`tiling` picks the tile width and the launch from the shape and the
frame count, :func:`column_bands` finds each tile's row range ``[lo, hi)``
from the tensor (a dense G gives ``[0, window)``), :func:`quad_bands` each
column quad's, and :func:`band_layout` lays the bands out as the kernel
reads them; both are computed once per G and kept (:func:`_bands_of`). A skipped row would have added an exact zero,
so on finite samples the result is the dense product's. On a NaN or an Inf
it would not be: ``0 * NaN`` is NaN, so the dense product (the plain
version, and the JAX kernel) has NaN in EVERY column of a frame that holds
a non-finite sample wherever G has a zero in that row. The kernel keeps
that result: a CTA whose frames' span holds a NaN or an Inf sums over all
of G's rows, so NaN falls in the same places as in the plain version.

Two launches (see the note at the head of ``csrc/framed_gemm.cu``): the
long launch cuts the frames only. In its slot form (long hops, deep bands:
the high input rates) a CTA walks blocks of frames, each frame staged in a
slot of its own by ``cp.async`` while the block before is summed, and a
thread sums over the band of its 4 adjacent columns (:func:`quad_bands`);
in its run form a CTA stages its frames' span once for every column tile.
Where the run form would give fewer than :data:`CTAS_PER_SM` CTAs an SM (a
channel of a few seconds), the band launch puts groups of column tiles on
the grid too, and a CTA stages only its group's bands of rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from syllable_detector_tpu_torch.ops.stft import frame_signal, hop_length, normalize_overlap

__all__ = [
    "FRAMED_GEMM_LAUNCHES",
    "LAUNCH_KINDS",
    "Tiling",
    "tiling",
    "column_bands",
    "band_layout",
    "framed_gemm",
    "framed_gemm_reference",
    "CTAS_PER_SM",
    "band_tiling",
    "launch_ctas",
    "launch_tiling",
    "long_tiling",
    "quad_bands",
    "slot_tiling",
]

# Kernel launches in this process; reset to 0 before a run whose launches
# are to be counted. LAUNCH_KINDS splits them by launch (Tiling.band).
FRAMED_GEMM_LAUNCHES = 0
LAUNCH_KINDS = {"long": 0, "band": 0}
# Dynamic shared memory one CTA may opt in to on Hopper (227 KB), and the
# span above which a CTA takes fewer frames: small CTAs, many to an SM, hide
# the staging of one behind the sums of another (on an H100 at 48k -> 44.1k,
# 32 frames a CTA took two thirds of the time of 64 and half that of 128).
SMEM_LIMIT = 232448
SPAN_TARGET = 24 * 1024
# The kernel's register tile: frames x columns per thread; a thread takes
# NARROW_FRAMES frames where a unit of FRAMES_PER_THREAD would not fit.
FRAMES_PER_THREAD = 8
NARROW_FRAMES = 4
COLS_PER_THREAD = 4
MAX_WARPS = 8
# A CTA with fewer units than SPLIT_WARPS splits the rows of each over
# several warps, a part of at least MIN_PART_ROWS rows each.
SPLIT_WARPS = 4
MIN_PART_ROWS = 16
# The band launch: taken where the long launch leaves SMs idle (see
# tiling; on an H100 the band launch lost to the long one, though not to
# unfold @ g, on shallow bands where the long launch gave an SM a CTA or
# more, scripts/k2_rate_grid.py). A CTA takes one unit of BAND_FRAMES
# frames a thread (2 beat 4 and 8 on all but a few rate pairs: a short chain
# of loads and sums a CTA) of a group of column tiles, the fewest groups
# that give CTAS_PER_SM CTAs an SM; up to MAX_WARPS warps split a unit's
# rows, parts of at least MIN_PART_ROWS. SMS: the SMs counted when the
# caller gives none (an H100's).
CTAS_PER_SM = 2
BAND_FRAMES = 2
SMS = 132
# The long launch's slot form: taken where a frame's slot (the window
# rounded up to an odd multiple of 4 floats) is at most SLOT_HOPS hops, so
# that staging each frame on its own repeats little of the overlap of
# neighbouring frames; else the run form stages the span as one run. A
# warp is up to 4 column quads by 8 frame lanes, a lane SLOT_FRAMES frames;
# up to MAX_SLOT_WARPS warps share the groups of quads of a block, and a
# row split gives a group's rows to 2, 4 or 8 warps, parts of at least
# MIN_SLOT_PART_ROWS rows of the deepest quad's band: 4 frames a lane for
# FEW_GROUPS groups or fewer, else 2, and the least split that keeps
# SLOT_WARPS_SM warps busy an SM (slot_tiling; on an H100 this took the
# fastest of the variants on every 60 s rate pair that takes the slot
# form, scripts/k2_choices.py). SLOT_REGISTERS: the registers a thread of each
# frames-a-lane instantiation takes at most (ptxas' count, held by
# chip_smoke.py phase 2), and SMEM_SM the shared memory of one SM (1 KB of
# it reserved for each CTA), which set the CTAs an SM holds.
SLOT_HOPS = 4
SLOT_FRAMES = (4, 2, 1)
MAX_SLOT_WARPS = 16
MIN_SLOT_PART_ROWS = 40
FEW_GROUPS = 5
SLOT_WARPS_SM = 12
# The slot form stands against the run form where the deepest quad's band
# has SLOT_DEPTH rows or more, or where there are at most SLOT_QUADS column
# quads and a slot is at most SLOT_SHORT_HOPS hops (scripts/k2_choices.py:
# shallower bands over more columns, or slots that repeat more of the
# overlap, went faster in the run form on an H100).
SLOT_DEPTH = 40
SLOT_QUADS = 40
SLOT_SHORT_HOPS = 1.25
SLOT_REGISTERS = {4: 110, 2: 89, 1: 116}
SMEM_SM = 233472


class Tiling(NamedTuple):
    """How one launch is cut: a warp is ``32 // cg`` threads across frames
    by ``cg`` across columns, a thread owns ``fpt`` frames x 4 columns, so a
    warp's unit is ``fpt * 32 // cg`` frames x ``cw = 4 * cg`` columns.

    The long launch's run form (``stride`` 0): a CTA stages the span of
    ``frames`` frames as one run, and its warps take the ``n_tiles * frames
    // unit`` units in turn; a thread's columns are spread over a tile
    (``j * cg + ci``) and it sums over the tile's band of rows. Its slot
    form (:attr:`slots`, ``stride`` > 0): a thread's 4 columns are adjacent
    (a quad, ``cg`` quads a warp, ``n_tiles`` groups of them) and it sums
    over the quad's band; a CTA of ``threads`` walks blocks of ``frames`` =
    one unit of frames, each frame staged in a slot of ``stride`` floats,
    two blocks' slots at once (``span_bytes``), ``per_sm`` CTAs an SM. The
    band launch (``band``): a CTA takes one unit of each of ``group``
    column tiles and stages their bands' ``rows`` alone, frame by frame at
    ``stride`` floats (or as one run where ``stride`` is the hop). With
    ``ksplit`` above 1, ``ksplit`` warps share each unit (each group of
    quads), a part of the rows each."""

    cg: int  # threads of a warp across columns: 1, 2, 4 or 8
    cw: int  # columns per tile
    n_tiles: int  # column tiles
    frames: int  # frames per CTA
    ksplit: int  # warps per unit
    threads: int  # threads per CTA
    vec: bool  # staged samples read as float4 along k
    span_bytes: int  # shared memory per CTA for the samples
    fpt: int = FRAMES_PER_THREAD  # frames per thread
    band: bool = False  # the band launch: a group of column tiles a CTA, their bands staged
    stride: int = 0  # band launch: floats between staged frames (the hop: one run)
    group: int = 1  # band launch: column tiles a CTA takes
    rows: int = 0  # band launch: rows of G a CTA stages a frame, at most
    per_sm: int = 0  # slot form: CTAs an SM holds (the grid), else 0: a CTA a frame block

    @property
    def slots(self) -> bool:
        """The long launch's slot form: each frame staged in a slot of
        ``stride`` floats, two buffers, ``per_sm`` CTAs an SM walking the
        frame blocks; a lane owns 4 adjacent columns (a quad) and sums
        over that quad's band of rows."""
        return not self.band and self.stride > 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _span_bytes(frames: int, window: int, hop: int) -> int:
    # 8 floats of slack: a tile's rows run to lo + rows <= window + 6
    return _round_up((frames - 1) * hop + window + 8, 4) * 4


def tiling(
    window: int, m: int, hop: int, n_frames: int | None = None, sms: int | None = None,
    ranges: list[tuple[int, int]] | None = None, depth: int | None = None,
) -> Tiling:
    """The kernel's launch for ``n_frames`` frames of a ``[*, window] @
    [window, m]`` product at ``hop`` on a card of ``sms`` SMs (default
    :data:`SMS`), each column tile of the band launch summing over rows
    ``[lo4, lo4 + n)`` of ``ranges`` (as :func:`band_layout` gives them for
    :func:`band_tiling`'s tiles; default every row) and the deepest column
    quad's band ``depth`` rows (default the window). Without ``n_frames``,
    the long launch (:func:`long_tiling`); with it, the band launch
    (:func:`band_tiling`, where its samples fit in shared memory) where the
    long launch's run form would leave SMs idle: fewer than one CTA an SM
    over several column tiles, half of one over a single tile (where the
    band launch only re-cuts the frames), twice that where a band is deep
    enough to split over :data:`SPLIT_WARPS` warps. The rule was fitted to
    the run form and is kept for the slot form: on 5 s channels the band
    launch was as fast as the slot form or faster on most pairs it takes
    (scripts/k2_choices.py)."""
    cut = long_tiling(window, m, hop, n_frames, sms, depth)
    if n_frames is None:
        return cut
    sms = SMS if sms is None else sms
    cw, _ = _column_group(m)
    ranges = [(0, _round_up(window, 4))] * -(-m // cw) if ranges is None else list(ranges)
    run = _run_tiling(window, m, hop)
    idle = sms if run.n_tiles > 1 else sms // 2
    if max(n for _, n in ranges) >= SPLIT_WARPS * MIN_PART_ROWS:
        idle *= 2
    if launch_ctas(run, n_frames) >= idle:
        return cut
    return band_tiling(window, m, hop, n_frames, sms, ranges) or cut


def launch_ctas(cut: Tiling, n_frames: int, sms: int | None = None) -> int:
    """CTAs of a launch cut as ``cut`` over ``n_frames`` frames on a card of
    ``sms`` SMs (default :data:`SMS`; only the slot form's grid depends on
    them)."""
    blocks = -(-n_frames // cut.frames)
    if cut.slots:
        return min(blocks, cut.per_sm * (SMS if sms is None else sms))
    return blocks * (-(-cut.n_tiles // cut.group) if cut.band else 1)


def band_tiling(
    window: int, m: int, hop: int, n_frames: int, sms: int | None = None,
    ranges: list[tuple[int, int]] | None = None,
) -> Tiling | None:
    """The band launch: a CTA takes one unit of frames (:data:`BAND_FRAMES`
    a thread, 32 / cg threads across frames) of a group of neighbouring
    column tiles, the fewest groups that give :data:`CTAS_PER_SM` CTAs an SM
    (one tile a group where the frames do not allow that). It stages each
    frame's rows of the group's bands, from the first band's first row to
    the last band's end (``ranges``, as in :func:`tiling`): one by one at a
    stride of that depth rounded to an odd multiple of 4 where the hop is at
    least that, else as one run at the hop. Where a group's tiles leave
    warps to spare, ``ksplit`` warps share each unit, a part of its rows
    each (at least :data:`MIN_PART_ROWS`). None where the unit's samples do
    not fit in shared memory."""
    cw, cg = _column_group(m)
    n_tiles = -(-m // cw)
    ranges = [(0, _round_up(window, 4))] * n_tiles if ranges is None else list(ranges)
    fpt = BAND_FRAMES
    unit = fpt * 32 // cg
    sms = SMS if sms is None else sms
    groups = min(n_tiles, -(-CTAS_PER_SM * sms // -(-n_frames // unit)))
    group = -(-n_tiles // groups)
    depth, deepest = 4, 4
    for g0 in range(0, n_tiles, group):
        live = [(lo, n) for lo, n in ranges[g0 : g0 + group] if n > 0]
        if live:
            depth = max(depth, max(lo + n for lo, n in live) - min(lo for lo, _ in live))
            deepest = max(deepest, max(n for _, n in live))
    ksplit = 1
    while group * ksplit * 2 <= MAX_WARPS and deepest // (ksplit * 2) >= MIN_PART_ROWS:
        ksplit *= 2
    warps = group * ksplit if ksplit > 1 else min(group, MAX_WARPS)
    stride = _odd_quads(depth)
    frame_by_frame = hop >= stride
    staged = unit * stride if frame_by_frame else _round_up((unit - 1) * hop + depth, 4)
    red = 32 * warps * fpt * COLS_PER_THREAD if ksplit > 1 else 0
    if 4 * (staged + red) > SMEM_LIMIT:
        return None
    return Tiling(cg, cw, n_tiles, unit, ksplit, 32 * warps, frame_by_frame or hop % 4 == 0,
                  4 * staged, fpt, True, stride if frame_by_frame else hop, group, depth)


def _odd_quads(rows: int) -> int:
    """``rows`` rounded up to an odd multiple of 4 floats: frames staged at
    that stride read as float4 fall on distinct banks, 8 neighbouring
    frames at a time."""
    rows = _round_up(rows, 4)
    return rows if rows // 4 % 2 else rows + 4


def long_tiling(window: int, m: int, hop: int, n_frames: int | None = None,
                sms: int | None = None, depth: int | None = None) -> Tiling:
    """The long launch's tiling of a ``[*, window] @ [window, m]`` product
    at ``hop``: the slot form (:func:`slot_tiling`, for ``n_frames`` frames
    on ``sms`` SMs) where the deepest quad's band (``depth`` rows, default
    the window) has :data:`SLOT_DEPTH` rows or more, or where there are at
    most :data:`SLOT_QUADS` column quads and a slot is at most
    :data:`SLOT_SHORT_HOPS` hops, and where the slot form fits; else the
    run form.

    The run form: the narrowest column tile of 4, 8, 16 or 32 that holds
    ``m`` (32 for wider products), and as many frames per CTA as give 8
    warps a unit each, fewer while the staged span is above
    :data:`SPAN_TARGET`. A CTA left with one or two units (a narrow G at a
    long hop) gives each to 4 or 2 warps, a part of the rows each (at least
    :data:`MIN_PART_ROWS`), so that it has warps enough to hide its loads.
    Else a CTA has a warp per unit up to 4, 4 warps for 5 to 7 units (5
    such CTAs fit an SM's registers, 4 of 5 warps do not fill a wave of the
    resampler's grid) and 8 from 8 units on. A thread takes
    :data:`FRAMES_PER_THREAD` frames, or :data:`NARROW_FRAMES` where one
    unit's span would not fit in shared memory. Raises when even that does
    not fit."""
    deep = (window if depth is None else depth) >= SLOT_DEPTH
    if deep or (-(-m // COLS_PER_THREAD) <= SLOT_QUADS
                and _odd_quads(window) <= SLOT_SHORT_HOPS * hop):
        cut = slot_tiling(window, m, hop, n_frames, sms, depth)
        if cut is not None:
            return cut
    return _run_tiling(window, m, hop)


def _run_tiling(window: int, m: int, hop: int) -> Tiling:
    """The long launch's run form: :data:`FRAMES_PER_THREAD` frames a
    thread, or :data:`NARROW_FRAMES` where that does not fit; raises where
    neither does."""
    for fpt in (FRAMES_PER_THREAD, NARROW_FRAMES):
        cut = _tiling(window, m, hop, fpt)
        if cut is not None:
            return cut
    need = _span_bytes(NARROW_FRAMES * 32 // _column_group(m)[1], window, hop)
    raise ValueError(
        f"the framed GEMM kernel stages {need} bytes per CTA at window "
        f"{window}, hop {hop}; the card offers {SMEM_LIMIT}"
    )


def slot_tiling(window: int, m: int, hop: int, n_frames: int | None = None,
                sms: int | None = None, depth: int | None = None, fpt: int | None = None,
                ksplit: int | None = None) -> Tiling | None:
    """The long launch's slot form for ``n_frames`` frames on a card of
    ``sms`` SMs (default :data:`SMS`; without ``n_frames``, enough to fill
    it), or None where a slot (``window`` rounded up to an odd multiple of
    4 floats) is longer than :data:`SLOT_HOPS` hops or two blocks' slots do
    not fit. A warp takes ``cg`` = 4 column quads by 8 frame lanes (2 or 1
    quads where 4 would leave over a quarter of the lanes idle), ``fpt``
    frames a lane; a CTA's warps take the groups of quads of a block, up to
    :data:`MAX_SLOT_WARPS`, evenly, or with a row split ``ksplit`` warps a
    group, parts of at least :data:`MIN_SLOT_PART_ROWS` rows of the deepest
    quad's band (``depth``, default the window).

    Unless given, ``fpt`` starts at 4 where there are at most
    :data:`FEW_GROUPS` groups (a CTA of few warps keeps more sums in flight
    a warp) and at 2 else, and falls to 2 and 1 where no row split gives
    :data:`SLOT_WARPS_SM` warps busy an SM or the buffers do not fit; the
    row split is the least that gives that many, else the one that gives
    the most. The grid is the CTAs the card holds at once (``per_sm`` an
    SM, by shared memory, threads and :data:`SLOT_REGISTERS`)."""
    stride = _odd_quads(window)
    if stride > SLOT_HOPS * hop:
        return None
    n_quads = -(-m // COLS_PER_THREAD)
    qpw = next((q for q in (4, 2) if n_quads >= q
                and 4 * (_round_up(n_quads, q) - n_quads) <= n_quads), 1)
    groups = -(-n_quads // qpw)
    depth = window if depth is None else depth
    sms = SMS if sms is None else sms
    if fpt is None:
        start = 4 if groups <= FEW_GROUPS else 2
        lane_frames = [f for f in SLOT_FRAMES if f <= start]
    else:
        lane_frames = [fpt]
    best, most = None, -1.0
    for f in lane_frames:
        for parts in (1, 2, 4, 8) if ksplit is None else (ksplit,):
            if ksplit is None and parts > 1 and depth // parts < MIN_SLOT_PART_ROWS:
                break
            cut = _slot_cut(stride, qpw, groups, f, parts)
            if cut is None:
                continue
            ctas = cut.per_sm if n_frames is None else min(
                cut.per_sm, -(-n_frames // cut.frames) / sms)
            busy = ctas * cut.threads // 32
            if busy >= SLOT_WARPS_SM:
                return cut
            if busy > most:
                best, most = cut, busy
    return best


def _slot_cut(stride: int, qpw: int, groups: int, fpt: int, ksplit: int) -> Tiling | None:
    """The slot form at ``fpt`` frames a lane and a row split of
    ``ksplit``, or None where it does not fit."""
    if ksplit > 1:
        warps = groups * ksplit  # one warp per part of each group
        if warps > MAX_SLOT_WARPS:
            return None
    else:
        rounds = -(-groups // MAX_SLOT_WARPS)
        warps = -(-groups // rounds)
    frames = fpt * 32 // qpw
    staged = 2 * frames * stride
    red = 32 * warps * fpt * COLS_PER_THREAD if ksplit > 1 else 0
    smem = 4 * (staged + red)
    if smem > SMEM_LIMIT:
        return None
    threads = 32 * warps
    per_sm = min(SMEM_SM // (smem + 1024), 2048 // threads,
                 65536 // (_round_up(SLOT_REGISTERS[fpt], 8) * threads))
    return Tiling(qpw, 4 * qpw, groups, frames, ksplit, threads, True, 4 * staged, fpt, False,
                  stride, 1, 0, max(1, per_sm))


def _column_group(m: int) -> tuple[int, int]:
    """(columns per tile, threads of a warp across them) for ``m`` columns."""
    cw = next((w for w in (4, 8, 16) if m <= w), 32)
    return cw, cw // COLS_PER_THREAD


def _tiling(window: int, m: int, hop: int, fpt: int) -> Tiling | None:
    """The long launch's run form with ``fpt`` frames a thread, or None
    where one unit's span does not fit."""
    cw, cg = _column_group(m)
    n_tiles = -(-m // cw)
    unit = fpt * 32 // cg
    blocks = max(1, -(-MAX_WARPS // n_tiles))
    while blocks > 1 and _span_bytes(blocks * unit, window, hop) > SPAN_TARGET:
        blocks -= 1
    span = _span_bytes(blocks * unit, window, hop)
    units = n_tiles * blocks
    ksplit = 1
    while units * ksplit * 2 <= SPLIT_WARPS and window // (ksplit * 2) >= MIN_PART_ROWS:
        ksplit *= 2
    if ksplit > 1:
        warps = units * ksplit  # one warp per part of each unit
        span_and_sums = span + 4 * 32 * warps * fpt * COLS_PER_THREAD
    else:
        warps = units if units <= 4 else 4 if units < MAX_WARPS else MAX_WARPS
        span_and_sums = span
    if span_and_sums > SMEM_LIMIT:
        return None
    return Tiling(cg, cw, n_tiles, blocks * unit, ksplit, 32 * warps, hop % 4 == 0, span, fpt)


def column_bands(g: torch.Tensor, cw: int) -> list[tuple[int, int]]:
    """For each tile of ``cw`` neighbouring columns of ``g`` [window, m],
    the row range ``[lo, hi)`` outside which all of the tile's columns are
    zero (``(0, 0)`` for a tile of zeros). A dense ``g`` gives
    ``(0, window)`` for every tile."""
    window, m = g.shape
    n_tiles = -(-m // cw)
    nz = torch.zeros((window, n_tiles * cw), dtype=torch.bool, device=g.device)
    nz[:, :m] = g != 0
    rows = nz.view(window, n_tiles, cw).any(dim=2)  # [window, tiles]
    idx = torch.arange(window, device=g.device)[:, None]
    lo = torch.where(rows, idx, window).min(dim=0).values
    hi = torch.where(rows, idx + 1, 0).max(dim=0).values
    return [(int(a), int(b)) if b > a else (0, 0) for a, b in zip(lo.tolist(), hi.tolist())]


def band_layout(
    g: torch.Tensor, bands: list[tuple[int, int]], cg: int, quads: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(band [tiles, rows, 4*cg] float32, ranges [tiles, 2] int32)`` on
    ``g``'s device, as the kernel reads them: tile t covers rows ``[lo4,
    lo4 + n)`` of ``g`` with ``lo4 = lo`` rounded down and ``n`` rounded up
    to a multiple of 4 (``ranges[t] = (lo4, n)``; rows past ``hi`` or the
    window are zero), and a thread's four columns lie side by side:
    ``band[t, r, ci*4 + j] = g[lo4 + r, t*cw + j*cg + ci]``.

    With ``quads``, ``bands`` are the column quads' (as :func:`quad_bands`
    gives them at ``cg``, each group of ``cg`` quads as deep) and the
    layout is the slot form's: ``(band [groups, rows, 4*cg], ranges
    [quads, 2])``, quad ``q = grp*cg + qi`` at ``band[grp, r, qi*4 + j] =
    g[lo4 + r, 4*q + j]``, so that a warp's quads read one row of their
    bands from 16 * cg neighbouring bytes."""
    if quads:
        band, ranges = band_layout(g, bands, 1)  # [quads, rows, 4]
        groups = -(-len(bands) // cg)
        band = torch.cat([band, band.new_zeros((groups * cg - len(bands), *band.shape[1:]))])
        band = band.view(groups, cg, -1, COLS_PER_THREAD).transpose(1, 2)
        return band.reshape(groups, -1, COLS_PER_THREAD * cg).contiguous(), ranges
    window, m = g.shape
    cw = COLS_PER_THREAD * cg
    ranges = [(lo // 4 * 4, _round_up(hi - lo // 4 * 4, 4)) for lo, hi in bands]
    depth = max(4, max(n for _, n in ranges))
    padded = g.new_zeros((window + 4, len(bands) * cw))
    padded[:window, :m] = g
    band = g.new_zeros((len(bands), depth, cw))
    for t, (lo4, n) in enumerate(ranges):
        src = padded[lo4 : lo4 + n, t * cw : (t + 1) * cw]
        band[t, :n] = src.reshape(n, COLS_PER_THREAD, cg).transpose(1, 2).reshape(n, cw)
    return band.contiguous(), torch.tensor(ranges, dtype=torch.int32, device=g.device)


def quad_bands(g: torch.Tensor, cg: int) -> list[tuple[int, int]]:
    """The slot form's row range ``[lo, hi)`` of each column quad of ``g``
    [window, m] (4 neighbouring columns): the quad's band as
    :func:`column_bands` finds it, widened to multiples of 4 and, in each
    group of ``cg`` quads (a warp's), to the group's deepest band, moved up
    where that would run past the window rounded up to 4 (the rows added
    are zero in the quad's columns). A dense ``g`` gives ``(0, window)``
    rounded up to 4 for every quad; a group of zero quads ``(0, 0)``."""
    w4 = _round_up(g.shape[0], 4)
    own = [(lo // 4 * 4, _round_up(hi - lo // 4 * 4, 4)) if hi > lo else (0, 0)
           for lo, hi in column_bands(g, COLS_PER_THREAD)]
    out = []
    for g0 in range(0, len(own), cg):
        rows = max(n for _, n in own[g0 : g0 + cg])
        out += [(lo, lo + rows) for lo in (min(lo, w4 - rows) for lo, _ in own[g0 : g0 + cg])]
    return out


# (data pointer, version, shape, device) of a G -> (G, band, ranges, bands):
# G itself is held so that its memory cannot be handed to another tensor
# while the entry lives; an in-place write to G changes its version.
_BANDS: dict = {}
_BANDS_KEPT = 16


def _bands_of(g: torch.Tensor, cg: int, quads: bool = False):
    """(g, band, ranges, the ranges as a host list) of ``g`` at ``cg``: the
    column tiles' bands, or with ``quads`` the slot form's quad bands."""
    key = (g.data_ptr(), g._version, tuple(g.shape), g.device, cg, quads)
    hit = _BANDS.get(key)
    if hit is None:
        if quads:
            band, ranges = band_layout(g, quad_bands(g, cg), cg, quads=True)
        else:
            band, ranges = band_layout(g, column_bands(g, COLS_PER_THREAD * cg), cg)
        hit = (g, band, ranges, [tuple(r) for r in ranges.tolist()])
        while len(_BANDS) >= _BANDS_KEPT:
            _BANDS.pop(next(iter(_BANDS)))
        _BANDS[key] = hit
    return hit


def framed_gemm_reference(
    x: torch.Tensor, g: torch.Tensor, window: int, window_overlap: int, n_frames: int
) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``frame_signal(x) @ g``, [n] x
    [window, m] -> [n_frames, m] float32, on any device."""
    return frame_signal(x, n_frames, window, window_overlap) @ g


def framed_gemm(
    x: torch.Tensor, g: torch.Tensor, window: int, window_overlap: int, n_frames: int
) -> torch.Tensor:
    """``frame_signal(x, n_frames, window, window_overlap) @ g``: [n] float32
    x [window, m] float32 -> [n_frames, m] float32. A CUDA ``x`` launches the
    kernel, or raises; a CPU ``x`` runs :func:`framed_gemm_reference`. Any
    ``g`` is served; the zero rows of its column tiles are found once per
    ``g`` and skipped, and a non-finite sample gives NaN where the dense
    product has it (see the note at the head of this module)."""
    global FRAMED_GEMM_LAUNCHES
    if g.dim() != 2 or g.shape[0] != window:
        raise ValueError(f"g of shape {tuple(g.shape)} does not have {window} rows")
    if x.device.type == "cpu":
        return framed_gemm_reference(x, g, window, window_overlap, n_frames)
    _check_launchable(x, g)
    m = g.shape[1]
    if n_frames <= 0:
        return x.new_zeros((0, m))
    cut = launch_tiling(x, g, window, window_overlap, n_frames)
    out = _launch(x, g, window, window_overlap, n_frames, cut)
    FRAMED_GEMM_LAUNCHES += 1
    LAUNCH_KINDS["band" if cut.band else "long"] += 1
    return out


def launch_tiling(x: torch.Tensor, g: torch.Tensor, window: int, window_overlap: int,
                  n_frames: int) -> Tiling:
    """The launch :func:`framed_gemm` takes for these arguments on ``x``'s
    card (:func:`tiling` with the card's SMs and G's row bands)."""
    hop = hop_length(window, window_overlap)
    _, cg = _column_group(g.shape[1])
    depth = max(n for _, n in _bands_of(g, 1)[3])  # the deepest column quad's band
    return tiling(window, g.shape[1], hop, n_frames, _sm_count(x.device), _bands_of(g, cg)[3],
                  depth)


def _launch(x: torch.Tensor, g: torch.Tensor, window: int, window_overlap: int,
            n_frames: int, cut: Tiling) -> torch.Tensor:
    """One launch of the kernel, cut as ``cut``. Counts nothing."""
    m = g.shape[1]
    lib = _library()
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window, window_overlap)
    _, band, ranges, _ = _bands_of(g, cut.cg, cut.slots)
    out = torch.empty((n_frames, m), dtype=torch.float32, device=x.device)
    # the library makes x's card current; the guard gives the caller's back
    with torch.cuda.device(x.device):
        err = lib.sd_framed_gemm(
            x.data_ptr(), x.shape[0], g.data_ptr(), window, m, hop, gap, n_frames,
            out.data_ptr(), band.data_ptr(), ranges.data_ptr(), band.shape[1], cut.cg,
            cut.ksplit, cut.fpt, cut.frames, cut.threads, int(cut.vec), int(cut.band),
            cut.group, cut.rows, cut.stride, launch_ctas(cut, n_frames, _sm_count(x.device)),
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"framed GEMM kernel launch failed (window {window}, {m} columns, hop {hop}, "
            f"{cut}): {lib.sd_framed_gemm_error_string(err).decode()} (cudaError {err})"
        )
    return out


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_launchable(x: torch.Tensor, g: torch.Tensor) -> None:
    """Raise unless ``x`` and ``g`` are contiguous float32 tensors on one
    Hopper card."""
    if x.device.type != "cuda":
        raise ValueError(f"no framed GEMM kernel for device {x.device}")
    if g.device != x.device:
        raise ValueError("g and the samples lie on different devices")
    for name, t, dim in (("samples", x, 1), ("g", g, 2)):
        if t.dtype != torch.float32 or t.dim() != dim or not t.is_contiguous():
            raise ValueError(
                f"the framed GEMM kernel takes contiguous float32 {name} of rank {dim}, "
                f"got {t.dtype} of shape {tuple(t.shape)}"
            )
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(
            "the framed GEMM kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(x.device)} is not"
        )


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound kernel library (built at the first launch)."""
    from syllable_detector_tpu_torch.kernels import _build

    lib = _build.load("framed_gemm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sd_framed_gemm.argtypes = [p, ll, p, i, i, i, i, ll, p, p, p] + [i] * 13 + [p]
    lib.sd_framed_gemm.restype = i
    lib.sd_framed_gemm_error_string.argtypes = [i]
    lib.sd_framed_gemm_error_string.restype = ctypes.c_char_p
    return lib
