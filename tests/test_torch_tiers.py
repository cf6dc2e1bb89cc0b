"""The port's precision tiers (bf16 hi/lo products), frames input and
slabbed grid layout against the JAX package's Pallas kernel, run in
interpret mode on the CPU.

On the CPU the port runs each kernel's plain version. Tolerances, plain
version against the JAX kernel with the same tier: rtol=2e-3, atol=5e-4 for
``split=True`` and ``split="conv"`` (tests/test_kernels.py's bound for the
split tiers), rtol=1e-2, atol=1e-2 for ``split=4`` (the JAX package's own
test of it) and for ``fast`` (one bf16 pass keeps about three digits; in
interpret mode the JAX kernel's DEFAULT precision is a float32 product, so
this compares one bf16 pass with fp32; log scaling amplifies the rounding
of small magnitudes, and ``fast`` is held to 5e-2 there).
Frames input and the fp32 grid layout: rtol=1e-4, atol=1e-5, the port's
contract for its fp32 paths against the JAX functions. NaN (digital silence
under l2normalize) must fall in the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syllable_detector_tpu.kernels import fused_detector as jfused
from syllable_detector_tpu_torch import fixtures
from syllable_detector_tpu_torch.kernels import fused_detector as tfused
from syllable_detector_tpu_torch.models import detector as tdet
from test_torch_fused_detector import both

torch.set_num_threads(1)

TIER_KW = fixtures.TIER_CASES  # tier -> (the JAX functions' keywords, rtol, atol)
CASES = {case[0]: case for case in fixtures.fused_cases(seconds=0.5)}


def close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def lanes_audio(lanes: int, seconds: float = 0.25) -> np.ndarray:
    return np.stack([fixtures.chirp_audio(seconds, 70 + i) for i in range(lanes)])


def stacked(lanes: int):
    """(port spec, per-lane port params, JAX spec, per-lane JAX params) for
    ``lanes`` nets of one geometry with their own seeded weights."""
    quads = [both(fixtures.sample_geometry_config(80 + i)) for i in range(lanes)]
    return quads[0][0], [q[1] for q in quads], quads[0][2], [q[3] for q in quads]


def test_tiers_table_matches_jax_arguments():
    assert set(tfused.TIERS) == set(TIER_KW) == set(tfused.TIER_LAUNCHES)
    assert tfused._tier_of(False, None) is None and tfused._tier_of(False, False) is None
    for tier, (kw, _, _) in TIER_KW.items():
        assert tfused._tier_of(kw.get("fast", False), kw.get("split")) == tier
    assert tfused._tier_of(True, 4) == "fast"  # fast wins, as in the JAX kernel
    with pytest.raises(ValueError, match="unknown split"):
        tfused._tier_of(False, 2)
    with pytest.raises(ValueError, match="unknown tier"):
        spec, params = tdet.detector_spec_from_config(CASES["linear"][1], "cpu")
        tfused.fused_tier_outputs_reference(
            spec, tfused.fold_constants(spec, params, "cpu"), torch.zeros(1, 5000), "tf32"
        )


def untile_bf16(tiled: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of the kernel's bf16 tiling (``[blocks, 2, steps,
    chunks, 8, 2, 8, 8]``, each k-step's rows in ``BF16_STEP_ORDER``): the
    (hi, lo) halves as ``[rows, cols]`` float32 in their natural row order."""
    blocks, _, steps, chunks = tiled.shape[:4]
    # (block, half, step, chunk, column block, k half, column, k)
    t = tiled.float().permute(1, 0, 2, 5, 7, 3, 4, 6)
    t = t.reshape(2, blocks * steps, 16, chunks * 64)
    inverse = torch.argsort(torch.tensor(tfused.BF16_STEP_ORDER))
    t = t[:, :, inverse].reshape(2, blocks * steps * 16, chunks * 64)
    return t[0], t[1]


@pytest.mark.parametrize("name", ["linear", "deep", "gap"])
def test_split_operands_are_the_jax_halves(name):
    """The bf16 halves the kernel reads: hi + lo of C and of the conv filter
    bank equal the JAX kernel's ``hi_lo`` of its own operands; the kernel's
    tiles (tile_dft_matrix_bf16, tile_conv_bank_bf16), untiled, hold them
    bit for bit, and their padding is zero in both halves, for shared and
    per-lane nets."""
    tspec, tparams, jspec, jparams = both(CASES[name][1])
    folded = tfused.fold_constants(tspec, tparams, "cpu")
    c_hi, c_lo, w_hi, w_lo = tfused.split_operands(folded.c, folded.w1)
    ops, meta = jfused.fold_constants(jspec, jparams, pack=False)
    window, b, t_range = tspec.window_length, tspec.n_bins, tspec.time_range
    h1 = folded.c1.shape[0]
    assert c_hi.dtype == c_lo.dtype == w_hi.dtype == torch.bfloat16
    assert c_hi.shape == (-(-window // 16) * 16, -(-2 * b // 16) * 16)
    assert w_hi.shape == (-(-b // 16) * 16, -(-t_range * h1 // 16) * 16)

    def jax_halves(a):
        hi = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
        lo = (jnp.asarray(a) - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        return np.asarray(hi.astype(jnp.float32)), np.asarray(lo.astype(jnp.float32))

    want_hi, want_lo = jax_halves(np.concatenate(
        [ops[0][:, :b], ops[0][:, meta.b_pad : meta.b_pad + b]], axis=1))
    np.testing.assert_array_equal(c_hi[:window, : 2 * b].float().numpy(), want_hi)
    np.testing.assert_array_equal(c_lo[:window, : 2 * b].float().numpy(), want_lo)
    w_want_hi, w_want_lo = jax_halves(ops[1])
    for t in range(t_range):
        cols = slice(t * h1, (t + 1) * h1)
        jcols = slice(t * meta.hs, t * meta.hs + h1)
        np.testing.assert_array_equal(w_hi[:b, cols].float().numpy(), w_want_hi[:b, jcols])
        np.testing.assert_array_equal(w_lo[:b, cols].float().numpy(), w_want_lo[:b, jcols])
    for half in (c_hi, c_lo):
        assert not half[:, 2 * b :].float().any() and not half[window:].float().any()
    for half in (w_hi, w_lo):
        assert not half[b:].float().any() and not half[:, t_range * h1 :].float().any()

    # the kernel's tiles: C with its columns in tiles of 8 (re, then im, of
    # 8 bins), rows in blocks of 32; the bank in k-steps of 16
    tiled = folded.c_bf16
    chunks = -(-2 * 8 * -(-b // 8) // 64)
    assert tiled.dtype == torch.bfloat16 and tiled.is_contiguous()
    assert tiled.shape == (-(-window // 32), 2, 2, chunks, 8, 2, 8, 8)
    cols = (torch.arange(b) // 8) * 16 + torch.arange(b) % 8
    for got, want in zip(untile_bf16(tiled), (c_hi, c_lo)):
        assert got.shape == (-(-window // 32) * 32, chunks * 64)
        np.testing.assert_array_equal(got[:window, cols].numpy(), want[:window, :b].float().numpy())
        np.testing.assert_array_equal(got[:window, cols + 8].numpy(),
                                      want[:window, b : 2 * b].float().numpy())
        keep = torch.zeros_like(got, dtype=torch.bool)
        keep[:window, cols] = keep[:window, cols + 8] = True
        assert not got[~keep].any()
    bank = folded.w1g_bf16
    n = t_range * h1
    assert bank.shape == (2, -(-b // 16), -(-n // 64), 8, 2, 8, 8)
    for got, want in zip(untile_bf16(bank[:, :, None].transpose(0, 1)), (w_hi, w_lo)):
        np.testing.assert_array_equal(got[:b, :n].numpy(), want[:b, :n].float().numpy())
        assert not got[b:].any() and not got[:, n:].any()
    # per-lane nets: one filter bank per lane, the DFT matrix shared
    other = tdet.detector_spec_from_config(fixtures.sample_geometry_config(7), "cpu")[1]
    if name == "linear":
        stack = tfused.fold_constants_stacked(tspec, [tparams, other], "cpu")
        assert stack.c_bf16.shape == tiled.shape and stack.w1g_bf16.shape == (2, *bank.shape)
        np.testing.assert_array_equal(stack.c_bf16.float().numpy(), tiled.float().numpy())
        np.testing.assert_array_equal(stack.w1g_bf16[0].float().numpy(), bank.float().numpy())
        lane1 = tfused.fold_constants(tspec, other, "cpu").w1g_bf16
        np.testing.assert_array_equal(stack.w1g_bf16[1].float().numpy(), lane1.float().numpy())


def emulate_tier_dot(x: torch.Tensor, tiled: torch.Tensor, passes: int) -> torch.Tensor:
    """``x [.., K] @ B`` as the kernel computes it under a tier: B read from
    its bf16 tiles (in the tiles' row order), x split into bf16 halves in
    the same order, and per k-step of 16 the products added to ONE fp32
    accumulator, small terms first (lo.lo for 4 passes, lo.hi, hi.lo,
    hi.hi). Returns ``[.., cols]`` in the tiles' column order."""
    blocks, _, steps, chunks = tiled.shape[:4]
    t = tiled.float().permute(1, 0, 2, 5, 7, 3, 4, 6).reshape(2, blocks * steps, 16, chunks * 64)
    order = torch.tensor(tfused.BF16_STEP_ORDER)
    rows = blocks * steps * 16
    xp = torch.nn.functional.pad(x, (0, rows - x.shape[-1])).reshape(*x.shape[:-1], -1, 16)
    x_hi, x_lo = (h.float() for h in tfused._hi_lo(xp[..., order]))
    acc = x.new_zeros((*x.shape[:-1], chunks * 64))
    for s in range(blocks * steps):
        b_hi, b_lo = t[0, s], t[1, s]
        if passes == 4:
            acc = acc + x_lo[..., s, :] @ b_lo
        if passes >= 3:
            acc = acc + x_lo[..., s, :] @ b_hi
            acc = acc + x_hi[..., s, :] @ b_lo
        acc = acc + x_hi[..., s, :] @ b_hi
    return acc


def emulate_tier_outputs(spec, folded, x: torch.Tensor, tier: str) -> torch.Tensor:
    """One stream's outputs [E, outputs] through :func:`emulate_tier_dot`
    on the kernel's tiles for both GEMMs of ``tier`` (the TF32x3 DFT of
    ``split_dft_reference`` where the tier keeps it in fp32), the T
    diagonal blocks summed in t order, the rest as the plain version."""
    dft_passes, conv_passes = tfused.TIERS[tier]
    f = tdet.num_frames(len(x), spec.window_length, spec.window_overlap)
    n_evals = f - spec.time_range + 1
    frames = tdet.frame_signal(x, f, spec.window_length, spec.window_overlap)
    b = spec.n_bins
    if dft_passes:
        tiles = emulate_tier_dot(frames, folded.c_bf16, dft_passes)
        cols = (torch.arange(b) // 8) * 16 + torch.arange(b) % 8
        big = torch.cat([tiles[:, cols], tiles[:, cols + 8]], dim=1)
    else:
        big = tfused.split_dft_reference(frames, folded.c)
    mag = torch.sqrt(big[:, :b] ** 2 + big[:, b:] ** 2)
    if spec.scaling == "log":
        mag = torch.log(mag)
    elif spec.scaling == "db":
        mag = tfused.DB_PER_NEPER * torch.log(mag)
    h1 = folded.c1.shape[0]
    conv = emulate_tier_dot(mag, folded.w1g_bf16[:, :, None].transpose(0, 1), conv_passes)
    acc = 0.0
    for t in range(spec.time_range):
        acc = acc + conv[t : t + n_evals, t * h1 : (t + 1) * h1]
    if folded.has_l2:
        rowsq = torch.sum(mag * mag, dim=1)
        acc = acc / torch.sqrt(sum(rowsq[t : t + n_evals] for t in range(spec.time_range)))[:, None]
    h = tfused.apply_transfer(acc + folded.c1, spec.net.transfers[0])
    for (w, bb), name in zip(folded.mids, spec.net.transfers[1:]):
        h = tfused.apply_transfer(h @ w + bb, name)
    return h * folded.out_a + folded.out_c


@pytest.mark.parametrize("tier", list(TIER_KW))
@pytest.mark.parametrize("name", ["linear", "db", "gap", "deep"])
def test_tiled_pass_order_emulation_matches_jax(name, tier):
    """The kernel's arithmetic under a tier, emulated on the CPU over its
    tiled operands (one accumulator, small terms first per k-step), against
    the JAX kernel in interpret mode with the same tier, at the tier's
    tolerance (``fast`` under dB scaling: 5e-2, as above), and against the
    port's plain version (the same bf16 halves summed in another order:
    float32 rounding, amplified by log scaling only where |X| is tiny)."""
    _, cfg, x, _, _ = CASES[name]
    kw, rtol, atol = TIER_KW[tier]
    if tier == "fast" and name == "db":
        rtol = atol = 5e-2
    tspec, tparams, jspec, jparams = both(cfg)
    folded = tfused.fold_constants(tspec, tparams, "cpu")
    got = emulate_tier_outputs(tspec, folded, torch.from_numpy(x), tier).numpy()
    want = jfused.fused_offline_outputs(jspec, jparams, jnp.asarray(x), interpret=True, tile=64, **kw)
    close(got, want, rtol, atol)
    plain = tfused.fused_tier_outputs_reference(tspec, folded, torch.from_numpy(x)[None], tier)[0]
    close(got, plain.numpy(), 1e-4, 1e-4)


@pytest.mark.parametrize("tier", list(TIER_KW))
@pytest.mark.parametrize("name", ["linear", "log", "gap", "deep"])
def test_tier_plain_version_matches_jax(name, tier):
    _, cfg, x, _, _ = CASES[name]
    kw, rtol, atol = TIER_KW[tier]
    if tier == "fast" and name == "log":
        rtol = atol = 5e-2
    tspec, tparams, jspec, jparams = both(cfg)
    counts = dict(tfused.TIER_LAUNCHES)
    got = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x), **kw).numpy()
    assert tfused.TIER_LAUNCHES == counts  # a CPU tensor never launches
    want = jfused.fused_offline_outputs(
        jspec, jparams, jnp.asarray(x), interpret=True, tile=64, **kw
    )
    close(got, want, rtol, atol)
    folded = tfused.fold_constants(tspec, tparams, "cpu")
    ref = tfused.fused_tier_outputs_reference(tspec, folded, torch.from_numpy(x)[None], tier)
    np.testing.assert_array_equal(ref[0].numpy(), got)
    fp32 = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x)).numpy()
    finite = np.isfinite(fp32)
    close(got[finite], fp32[finite], rtol, atol)
    if tier == "fast":  # one bf16 pass does change the values
        assert np.abs(got[finite] - fp32[finite]).max() > 1e-6


@pytest.mark.parametrize("nets", ["shared", "distinct"])
@pytest.mark.parametrize("tier", list(TIER_KW))
def test_tier_grid_matches_jax(tier, nets):
    kw, rtol, atol = TIER_KW[tier]
    lanes = 5
    tspec, tparams, jspec, jparams = stacked(lanes)
    if nets == "shared":
        tparams, jparams = tparams[0], jparams[0]
    xs = lanes_audio(lanes)
    got = tfused.fused_batch_offline_outputs(
        tspec, tparams, torch.from_numpy(xs), slab_channels=2, **kw
    ).numpy()
    want = jfused.fused_batch_offline_outputs(
        jspec, jparams, jnp.asarray(xs), interpret=True, tile=64,
        layout="grid", slab_channels=2, **kw,
    )
    close(got, want, rtol, atol)


@pytest.mark.parametrize("nets", ["shared", "distinct"])
@pytest.mark.parametrize("slab", [2, 64, None])
def test_grid_layout_matches_jax(slab, nets):
    lanes = 5
    tspec, tparams, jspec, jparams = stacked(lanes)
    if nets == "shared":
        tparams, jparams = tparams[0], jparams[0]
    xs = lanes_audio(lanes)
    count = tfused.GRID_LAUNCHES
    got = tfused.fused_batch_offline_outputs(
        tspec, tparams, torch.from_numpy(xs), layout="grid", slab_channels=slab
    ).numpy()
    assert tfused.GRID_LAUNCHES == count
    want = jfused.fused_batch_offline_outputs(
        jspec, jparams, jnp.asarray(xs), interpret=True, tile=64,
        layout="grid", slab_channels=slab,
    )
    close(got, want, 1e-4, 1e-5)
    flat = tfused.fused_batch_offline_outputs(tspec, tparams, torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, flat)
    short = tfused.fused_batch_offline_outputs(
        tspec, tparams, torch.from_numpy(xs), layout="grid", slab_channels=slab, n_evals=7
    ).numpy()
    np.testing.assert_array_equal(short, got[:, :7])
    with pytest.raises(ValueError, match="needs more than"):
        tfused.fused_batch_offline_outputs(
            tspec, tparams, torch.from_numpy(xs), layout="grid", n_evals=10**6
        )


@pytest.mark.parametrize("name", ["linear", "db", "short", "gap", "deep"])
def test_frames_input_matches_jax(name):
    _, cfg, x, _, _ = CASES[name]
    tspec, tparams, jspec, jparams = both(cfg)
    count = tfused.FRAMES_LAUNCHES
    got = tfused.fused_offline_outputs(
        tspec, tparams, torch.from_numpy(x), input_mode="frames"
    ).numpy()
    assert tfused.FRAMES_LAUNCHES == count
    want = jfused.fused_offline_outputs(
        jspec, jparams, jnp.asarray(x), interpret=True, tile=64, input_mode="frames"
    )
    close(got, want, 1e-4, 1e-5)
    # raw input gives the same values (tests/test_kernels.py's bound)
    raw = tfused.fused_offline_outputs(tspec, tparams, torch.from_numpy(x)).numpy()
    close(got, raw, 1e-5, 1e-6)


def test_frames_reference_and_modes():
    _, cfg, x, _, _ = CASES["linear"]
    tspec, tparams, jspec, jparams = both(cfg)
    folded = tfused.fold_constants(tspec, tparams, "cpu")
    xt = torch.from_numpy(x)
    f = tdet.num_frames(len(x), tspec.window_length, tspec.window_overlap)
    frames = tdet.frame_signal(xt, f, tspec.window_length, tspec.window_overlap)
    got = tfused.fused_frames_outputs_reference(tspec, folded, frames)
    np.testing.assert_array_equal(
        got.numpy(), tfused.fused_offline_outputs(tspec, tparams, xt, input_mode="frames").numpy()
    )
    assert tfused.fused_frames_outputs_reference(tspec, folded, frames[:5]).shape == (0, 1)
    # frames input under a tier, as the JAX function allows
    tiered = tfused.fused_offline_outputs(tspec, tparams, xt, input_mode="frames", split=True)
    want = jfused.fused_offline_outputs(
        jspec, jparams, jnp.asarray(x), interpret=True, tile=64, input_mode="frames", split=True
    )
    close(tiered.numpy(), want, 2e-3, 5e-4)
    with pytest.raises(ValueError, match="unknown input_mode"):
        tfused.fused_offline_outputs(tspec, tparams, xt, input_mode="slab")
    with pytest.raises(ValueError, match=r"shape \[n\]"):
        tfused.fused_offline_outputs(tspec, tparams, xt[None])
    # packed is the TPU's lane layout: accepted, changes nothing
    np.testing.assert_array_equal(
        tfused.fused_offline_outputs(tspec, tparams, xt, packed=True).numpy(),
        tfused.fused_offline_outputs(tspec, tparams, xt).numpy(),
    )


@pytest.mark.parametrize("frames_input", [False, True])
def test_tier_tile_fills_whole_fragments(frames_input):
    """Every tier's CTA takes whole wgmma tiles of 64 frames and fits the
    card's 227 KB of shared memory on every fixture geometry, from samples
    and from frames; at the sample geometry a CTA of 128 frames holds about
    110 KB from samples, so two fit an SM."""
    for name, cfg, _, _, _ in CASES.values():
        spec, _ = tdet.detector_spec_from_config(cfg, "cpu")
        width = max(w for _, w in spec.net.layer_sizes)
        for tier in (None, *tfused.TIERS):
            for lanes, n_evals in ((1, 1), (1, 20035), (16, 31766), (256, 8), (256, 128)):
                frames = tfused.cta_frames(spec, n_evals, lanes, width, tier=tier,
                                           frames_input=frames_input)
                assert frames in tfused.CTA_FRAMES and frames > spec.time_range - 1
                smem = tfused.smem_bytes(spec, frames, width, tier, frames_input)
                assert smem <= tfused.SMEM_LIMIT, (name, tier, frames)
    spec, _ = tdet.detector_spec_from_config(CASES["linear"][1], "cpu")
    # span 17020 + 3 stages 6144 + spectrogram 3712 + row sums 128 + 2 x 119 x 4
    # activations: the bf16 conv product (128 x 72 floats) fits over the span
    # and its bank (2 x 2 k-steps x 512 floats) in the stages
    fp32 = 4 * (17020 + 6144 + 128 * 29 + 128 + 2 * 119 * 4)
    assert tfused.smem_bytes(spec, 128, 4) == fp32
    for tier in tfused.TIERS:
        assert tfused.smem_bytes(spec, 128, 4, tier) == fp32
    assert tfused.smem_bytes(spec, 128, 4, None, True) == fp32 + 4 * (128 * 260 - 17020)
    assert 2 * (fp32 + 1024) <= tfused.SM_SMEM
    # a wide first layer grows both regions: T * h1 = 10 * 64 columns
    wide = tdet.detector_spec_from_config(fixtures.sample_geometry_config(0, hidden=(64,)), "cpu")[0]
    got = tfused.smem_bytes(wide, 64, 64, "split")
    assert got == 4 * (64 * (640 + 8) + 2 * 2 * 10 * 512 + 64 * 29 + 64 + 2 * 55 * 64)


def test_cuda_tensors_never_fall_back():
    """Off the CPU every new entry goes for its kernel: a tensor on a
    device without one raises and runs no plain version."""
    spec, params = tdet.detector_spec_from_config(CASES["linear"][1], "cpu")
    folded = tfused.fold_constants(spec, params, "meta")
    x = torch.zeros(5000, device="meta")
    for kw in ({"split": True}, {"fast": True}, {"input_mode": "frames"}):
        with pytest.raises(ValueError, match="no fused detector kernel"):
            tfused.fused_offline_outputs(spec, params, x, folded=folded, **kw)
    for kw in ({"split": 4}, {"layout": "grid"}):
        with pytest.raises(ValueError, match="no fused detector kernel"):
            tfused.fused_batch_offline_outputs(spec, params, x[None], folded=folded, **kw)


@pytest.mark.cuda
def test_tier_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, cfg, x, _, _ in CASES.values():
        spec, params = tdet.detector_spec_from_config(cfg, "cuda")
        folded = tfused.fold_constants(spec, params, "cuda")
        xd = torch.from_numpy(x).cuda()
        for tier, (kw, rtol, atol) in TIER_KW.items():
            count = tfused.TIER_LAUNCHES[tier]
            got = tfused.fused_offline_outputs(spec, params, xd, folded=folded, **kw)
            torch.cuda.synchronize()
            assert tfused.TIER_LAUNCHES[tier] == count + 1
            want = tfused.fused_tier_outputs_reference(spec, folded, xd[None], tier)[0]
            close(got.cpu().numpy(), want.cpu().numpy(), rtol, atol)
        got = tfused.fused_offline_outputs(spec, params, xd, folded=folded, input_mode="frames")
        close(got.cpu().numpy(),
              tfused.fused_offline_outputs_reference(spec, folded, xd).cpu().numpy(), 1e-3, 2e-4)
        # one kernel and one DFT arithmetic: frames and samples agree bit for
        # bit, in full fp32 and under every tier
        for kw in ({}, *(case[0] for case in TIER_KW.values())):
            frames = tfused.fused_offline_outputs(spec, params, xd, folded=folded,
                                                  input_mode="frames", **kw)
            raw = tfused.fused_offline_outputs(spec, params, xd, folded=folded, **kw)
            close(frames.cpu().numpy(), raw.cpu().numpy(), 0, 0)


@pytest.mark.cuda
def test_grid_slabs_match_flat_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    spec, params = tdet.detector_spec_from_config(CASES["linear"][1], "cuda")
    xs = torch.from_numpy(lanes_audio(5)).cuda()
    count = tfused.GRID_LAUNCHES
    got = tfused.fused_batch_offline_outputs(spec, params, xs, layout="grid", slab_channels=2)
    torch.cuda.synchronize()
    assert tfused.GRID_LAUNCHES == count + 3
    flat = tfused.fused_batch_offline_outputs(spec, params, xs)
    close(got.cpu().numpy(), flat.cpu().numpy(), 0, 1e-6)
