"""The Hopper implicit-GEMM body's launch planner (``ops/downsample_conv.py``
``igemm_plan``) and the order of its arithmetic, on the CPU.

The body (``csrc/conv_igemm_sm90.cuh``) gives each block a 128-pixel
spatial tile of one sample's grid (of one parity phase for dgrad) and an N
tile, and walks K steps of 64 channels of one tap, each a TMA box whose
zero fill covers the pad, negative coordinates and the ragged edges.  Here:

- at every main-path shape of the downsample forward and dgrad and at
  ragged ones, the blocks cover every output pixel (every dx pixel across
  the four phases, whose taps number 4 + 2 + 2 + 1 = 9) and every output
  channel exactly once, the same shape gives the same plan, a block's
  shared memory fits the SM's 228 KB with the blocks an SM the plan
  states, and the grid fills the card;
- a plain emulation of the body's order (the plan's tiles, 64-channel K
  steps per tap read as zero-filled boxes, ``x + add`` summed in float32
  and rounded once before the products, float32 sums, bf16 rounding, the
  per-block column statistics in ascending rows and tiles) equals the
  port's plain versions and the JAX package's Pallas kernels run in
  interpret mode, at ragged shapes and at a main-path-shaped case at bs 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_from_gaussian_vae_tpu.ops import downsample_conv as jdown
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down

# y, dx: float32 sums of exact bf16 products in another order, then one
# bf16 rounding: at most one bf16 ulp apart (the card tests' bar)
BF16_ATOL = BF16_RTOL = 1e-2
STATS_RTOL = 1e-5  # the emulated statistics vs a float64 reduce of the emulated y
# the statistics against the JAX kernel's, over sum |y| (sum y^2): its y may
# differ from the emulation's by one bf16 ulp in a few elements
STATS_JAX_RTOL = 1e-4
SM_SHARED = 233472      # bytes of shared memory on one H100 SM (228 KB)
BLOCK_RESERVED = 1024   # bytes the hardware keeps per resident block
BLOCK_SMEM_MAX = 232448  # a block's dynamic shared memory limit

# (mode, B, H, W, C, O): x (B, H, W, C), w (3, 3, C, O)
MAIN = ([("fwd_add", 16, h, h, c, c) for h, c in [(256, 128), (128, 256), (64, 512)]]
        + [("dgrad", 16, h, h, c, c) for h, c in [(256, 128), (128, 256), (64, 512)]])
RAGGED = [
    ("fwd", 2, 8, 12, 32, 128),       # 24 output pixels: one ragged tile
    ("fwd_add", 3, 18, 34, 64, 128),  # tiles ragged in both directions
    ("fwd_add", 1, 32, 32, 32, 256),  # K = 32: half a step zero-filled; N tile 256
    ("fwd", 2, 200, 200, 128, 128),   # sd3unet's first downsample at 200x200
    ("fwd_add", 2, 64, 64, 512, 512),  # the smallest main-path shape at bs 2
    ("dgrad", 2, 10, 14, 32, 128),    # K = 128 (O), N = 32 (C) < a tile
    ("dgrad", 1, 2, 2, 256, 512),     # one cotangent pixel
    ("dgrad", 3, 18, 34, 256, 128),   # N tile 256
    ("dgrad", 1, 2, 30, 136, 96),     # one row; K = 96 and N = 136 ragged
    ("dgrad", 2, 18, 42, 72, 160),
    ("dgrad", 2, 64, 64, 512, 512),
]


def _blocks(plan, b):
    """(phase, sample, spatial tile, N tile) of every block, decoded from
    its index as the kernel does (the N tile fastest, the phase slowest)."""
    bid = np.arange(plan.grid)
    nt = bid % plan.n_tiles
    rest = bid // plan.n_tiles
    mt = rest % plan.tiles
    rest //= plan.tiles
    return rest // b, rest % b, mt, nt


@pytest.mark.parametrize("mode,b,h,w,c,o", MAIN + RAGGED)
def test_plan_covers_every_output_once(mode, b, h, w, c, o):
    plan = down.igemm_plan(mode, b, h, w, c, o)
    mh, mw = h // 2, w // 2
    assert plan.tile_h * plan.tile_w == down.IGEMM_PIXELS
    tiles_w = -(-mw // plan.tile_w)
    assert plan.tiles == -(-mh // plan.tile_h) * tiles_w
    # the tiles cover the grid and overhang it by less than a tile
    assert 0 <= -(-mh // plan.tile_h) * plan.tile_h - mh < plan.tile_h
    assert 0 <= tiles_w * plan.tile_w - mw < plan.tile_w
    n = o if mode != "dgrad" else c
    assert plan.n_tiles * plan.tile_n >= n > (plan.n_tiles - 1) * plan.tile_n
    phase, bb, mt, nt = _blocks(plan, b)
    assert phase.max() == plan.phases - 1
    # pixel p of a block's tile is (h0 + p // tile_w, w0 + p % tile_w)
    p = np.arange(down.IGEMM_PIXELS)
    rows = (mt // tiles_w * plan.tile_h)[:, None] + p // plan.tile_w
    cols = (mt % tiles_w * plan.tile_w)[:, None] + p % plan.tile_w
    keep = (rows < mh) & (cols < mw)
    pm, pn = (phase // 2)[:, None], (phase % 2)[:, None]
    if mode == "dgrad":  # the phase's pixel of dx
        rows, cols = 2 * rows + pm, 2 * cols + pn
    seen = np.zeros((b, h if mode == "dgrad" else mh, w if mode == "dgrad" else mw,
                     plan.n_tiles), dtype=np.int64)
    np.add.at(seen, (np.broadcast_to(bb[:, None], rows.shape)[keep], rows[keep], cols[keep],
                     np.broadcast_to(nt[:, None], rows.shape)[keep]), 1)
    assert (seen == 1).all()
    assert plan.phases == (4 if mode == "dgrad" else 1)


def _phase_taps(phase):
    """[(r, s, tr, tc)] of dgrad's parity phase (pm, pn) = divmod(phase, 2)
    in the kernel's order: tap (r, s) = (pm + 2 tr, pn + 2 tc) reads
    g[i - tr, j - tc] for dx[2 i + pm, 2 j + pn]."""
    pm, pn = divmod(phase, 2)
    return [(pm + 2 * tr, pn + 2 * tc, tr, tc)
            for tr in range(2 if pm == 0 else 1) for tc in range(2 if pn == 0 else 1)]


def test_dgrad_phases_take_each_tap_once_the_longest_first():
    taps = [_phase_taps(ph) for ph in range(4)]
    assert [len(t) for t in taps] == [4, 2, 2, 1]
    assert sorted((r, s) for t in taps for r, s, _, _ in t) == \
        [(r, s) for r in range(3) for s in range(3)]


def test_plans_repeat_fit_and_fill_the_card():
    for mode, b, h, w, c, o in MAIN + RAGGED:
        plan = down.igemm_plan(mode, b, h, w, c, o)
        assert plan == down.igemm_plan(mode, b, h, w, c, o)
        n = o if mode != "dgrad" else c
        assert plan.tile_n == (256 if n % 256 == 0 else 128)
        assert plan.blocks_per_sm == (2 if plan.tile_n == 128 and mode != "fwd_add" else 1)
        assert 3 <= plan.stages <= 4
        assert plan.smem <= BLOCK_SMEM_MAX
        assert plan.blocks_per_sm * (plan.smem + BLOCK_RESERVED) <= SM_SHARED
        # the epilogue stages the 128 x tile_n bf16 tile (and two rows of
        # float32 partial sums) in the ring
        assert plan.smem - 1024 >= 128 * plan.tile_n * 2 + 2 * plan.tile_n * 4
        if (mode, b, h, w, c, o) in MAIN:  # at least one full wave
            assert plan.grid >= plan.blocks_per_sm * down.SMS, (mode, h, plan)
    assert down.igemm_tile(128, 128) == (1, 128) and down.igemm_tile(32, 32) == (4, 32)
    assert down.igemm_tile(4, 6) == (4, 32) and down.igemm_tile(1, 1) == (1, 128)
    with pytest.raises(ValueError):
        down.igemm_plan("up", 1, 2, 2, 32, 128)


def _tiles(t, plan):
    """(B, rows, cols, ch), rows and cols whole tiles -> (B, tiles, 128, ch)
    in the kernel's pixel order."""
    b, rows, cols, ch = t.shape
    th, tw = plan.tile_h, plan.tile_w
    t = t.reshape(b, rows // th, th, cols // tw, tw, ch).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, plan.tiles, th * tw, ch)


def _untile(t, plan, mh, mw):
    """The inverse of _tiles, cut to the (mh, mw) grid."""
    b, _, _, ch = t.shape
    th, tw = plan.tile_h, plan.tile_w
    n_th, n_tw = -(-mh // th), -(-mw // tw)
    t = t.reshape(b, n_th, n_tw, th, tw, ch).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, n_th * th, n_tw * tw, ch)[:, :mh, :mw]


def _emulate_fwd(x, add, w, bias):
    """The forward's order: per tap (r, s) and 64-channel step, the zero-
    filled box of x (or of x + add, rounded once) at (2 h0 + r, 2 w0 + s)
    with stride 2, times the weights in float32; + the bf16 bias, rounded;
    the column statistics of each block over its rows in ascending order
    (two parts of 64 rows at tile_n 128, added in order), then the blocks'
    partials in ascending order."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    plan = down.igemm_plan("fwd" if add is None else "fwd_add", b, h, wd, c, o)
    mh, mw = h // 2, wd // 2
    th, tw = plan.tile_h, plan.tile_w
    rows, cols = -(-mh // th) * th, -(-mw // tw) * tw
    kc = -(-c // 64)
    a = x.float() if add is None else (x.float() + add.float()).to(torch.bfloat16).float()
    ap = torch.zeros((b, 2 * rows + 2, 2 * cols + 2, 64 * kc))  # the zero fill
    ap[:, :h, :wd, :c] = a
    wp = torch.zeros((3, 3, 64 * kc, o))
    wp[:, :, :c] = w.float()
    acc = torch.zeros((b, plan.tiles, 128, o))
    for t in range(9):
        r, s = divmod(t, 3)
        box = _tiles(ap[:, r:r + 2 * rows:2, s:s + 2 * cols:2], plan)
        for k in range(kc):
            acc = acc + box[..., 64 * k:64 * (k + 1)] @ wp[r, s, 64 * k:64 * (k + 1)]
    y = (acc + bias.to(torch.bfloat16).float()).to(torch.bfloat16)
    on_grid = torch.nn.functional.pad(torch.ones((1, mh, mw, 1)), (0, 0, 0, cols - mw, 0, rows - mh))
    yv = y.float() * _tiles(on_grid, plan)  # pixels off the grid stage 0
    parts = 2 if plan.tile_n == 128 else 1
    per = 128 // parts
    sums = []
    for part in range(parts):
        s_, ss_ = torch.zeros((b, plan.tiles, o)), torch.zeros((b, plan.tiles, o))
        for r in range(part * per, (part + 1) * per):
            v = yv[:, :, r]
            s_, ss_ = s_ + v, ss_ + v * v
        sums.append((s_, ss_))
    s_, ss_ = sums[0]
    for s2, ss2 in sums[1:]:
        s_, ss_ = s_ + s2, ss_ + ss2
    stats = torch.zeros((b, 2, o))
    for p in range(plan.tiles):  # conv_stats_reduce_kernel: the partials in ascending order
        stats = stats + torch.stack([s_[:, p], ss_[:, p]], dim=1)
    return _untile(y, plan, mh, mw), stats


def _emulate_dgrad(g, w):
    """dgrad's order: per phase, tap (r, s, tr, tc) and 64-channel step of
    O, the zero-filled box of g at (h0 - tr, w0 - tc) times w[r, s]^T in
    float32, rounded to bf16 and written to the phase's pixels of dx."""
    b, mh, mw, o = g.shape
    c = w.shape[2]
    plan = down.igemm_plan("dgrad", b, 2 * mh, 2 * mw, c, o)
    th, tw = plan.tile_h, plan.tile_w
    rows, cols = -(-mh // th) * th, -(-mw // tw) * tw
    kc = -(-o // 64)
    gp = torch.zeros((b, rows + 1, cols + 1, 64 * kc))  # row / column 0: coordinate -1
    gp[:, 1:1 + mh, 1:1 + mw, :o] = g.float()
    wp = torch.zeros((3, 3, c, 64 * kc))
    wp[..., :o] = w.float()
    dx = torch.zeros((b, 2 * mh, 2 * mw, c), dtype=torch.bfloat16)
    for phase in range(4):
        acc = torch.zeros((b, plan.tiles, 128, c))
        for r, s, tr, tc in _phase_taps(phase):
            box = _tiles(gp[:, 1 - tr:1 - tr + rows, 1 - tc:1 - tc + cols], plan)
            for k in range(kc):
                acc = acc + box[..., 64 * k:64 * (k + 1)] @ wp[r, s, :, 64 * k:64 * (k + 1)].t()
        pm, pn = divmod(phase, 2)
        dx[:, pm::2, pn::2] = _untile(acc.to(torch.bfloat16), plan, mh, mw)
    return dx


def _bf16(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
        torch.bfloat16)


def _conv_case(shape, o, with_add, seed):
    c = shape[-1]
    x = _bf16(shape, seed)
    add = _bf16(shape, seed + 1) if with_add else None
    w = _bf16((3, 3, c, o), seed + 2, (9 * c) ** -0.5)
    bias = _bf16((o,), seed + 3, 0.1).float()
    return x, add, w, bias


def _close_bf16(got, want):
    d = (got.float() - want.float()).abs()
    assert bool((d <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()), float(d.max())


def _stats_close(stats, y, rtol):
    yd = y.double().flatten(1, 2)
    ref = torch.stack([yd.sum(1), (yd * yd).sum(1)], dim=1)
    scale = torch.stack([yd.abs().sum(1), (yd * yd).sum(1)], dim=1).clamp_min(1e-30)
    assert float(((stats.double() - ref).abs() / scale).max()) <= rtol


FWD_CASES = [((2, 8, 12, 32), 128, False), ((3, 18, 34, 64), 128, True),
             ((1, 32, 32, 96), 256, True), ((2, 64, 64, 512), 512, True)]  # the last: main-path
DGRAD_CASES = [((2, 10, 14, 32), 128), ((1, 2, 30, 136), 96), ((2, 18, 42, 72), 160),
               ((3, 18, 34, 256), 128), ((2, 64, 64, 512), 512)]  # the last: main-path


@pytest.fixture(scope="module")
def fwd_runs():
    """Each forward case's inputs, emulation and plain version, once."""
    runs = {}
    for i, (shape, o, with_add) in enumerate(FWD_CASES):
        x, add, w, bias = _conv_case(shape, o, with_add, 10 * i)
        runs[i] = (x, add, w, bias, _emulate_fwd(x, add, w, bias),
                   down.downsample_conv3x3_gn_plain(x, w, bias, add))
    return runs


@pytest.fixture(scope="module")
def dgrad_runs():
    runs = {}
    for i, (shape, o) in enumerate(DGRAD_CASES):
        b, h, wd, c = shape
        g = _bf16((b, h // 2, wd // 2, o), 100 + i)
        w = _bf16((3, 3, c, o), 200 + i, (9 * o) ** -0.5)
        runs[i] = (g, w, _emulate_dgrad(g, w), down.downsample_dgrad_plain(g, w))
    return runs


@pytest.mark.parametrize("case", range(len(FWD_CASES)))
def test_emulated_forward_matches_plain(fwd_runs, case):
    _, _, _, _, (y, stats), (y_plain, stats_plain) = fwd_runs[case]
    assert y.shape == y_plain.shape
    _close_bf16(y, y_plain)
    _stats_close(stats, y, STATS_RTOL)
    _stats_close(stats_plain, y, STATS_JAX_RTOL)


@pytest.mark.parametrize("case", range(len(DGRAD_CASES)))
def test_emulated_dgrad_matches_plain(dgrad_runs, case):
    _, _, dx, dx_plain = dgrad_runs[case]
    assert dx.shape == dx_plain.shape
    _close_bf16(dx, dx_plain)


def _hwbc(t):
    return jnp.transpose(jnp.asarray(t.float().numpy()), (1, 2, 0, 3)).astype(jnp.bfloat16)


def _bhwc(a):
    return torch.from_numpy(np.asarray(jnp.transpose(a, (2, 0, 1, 3)).astype(jnp.float32)))


@pytest.mark.parametrize("case,block", [(0, 2), (1, 3), (3, 8)])
def test_emulated_forward_matches_pallas(fwd_runs, case, block):
    """The JAX kernel in row bands of `block` output rows (several each)."""
    x, add, w, bias, (y, stats), _ = fwd_runs[case]
    yt, jstats = jdown._downsample_conv(
        _hwbc(x), None if add is None else _hwbc(add), jnp.asarray(w.float().numpy()),
        jnp.asarray(bias.numpy()), block, True, True)
    y_jax = _bhwc(yt)
    _close_bf16(y, y_jax)
    _stats_close(stats, y_jax, STATS_JAX_RTOL)
    _stats_close(torch.from_numpy(np.asarray(jnp.sum(jstats, axis=0))), y, STATS_JAX_RTOL)


@pytest.mark.parametrize("case,block", [(0, 1), (2, 3), (4, 8)])
def test_emulated_dgrad_matches_pallas(dgrad_runs, case, block):
    g, w, dx, _ = dgrad_runs[case]
    want = jdown._downsample_dgrad(_hwbc(g), jnp.swapaxes(jnp.asarray(w.float().numpy()), -1, -2)
                                   .astype(jnp.bfloat16), w.shape[2], block, True)
    _close_bf16(dx, _bhwc(want))
