"""The Hopper implicit-GEMM body's launch planner (``ops/downsample_conv.py``
``igemm_plan``) and the order of its arithmetic, on the CPU.

The body (``csrc/conv_igemm_sm90.cuh``) gives each block a 128-pixel
spatial tile of one sample's grid (of one parity phase for the downsample's
dgrad) and an N tile, and walks K steps of 64 channels of one tap, each a
TMA box whose zero fill covers the pad, negative coordinates, the
upsample's masked halo and the ragged edges.  Here:

- at every main-path shape of the downsample forward and dgrad and of the
  upsample dgrad, and at ragged ones, the blocks cover every output pixel
  (every dx pixel across the four phases, whose taps number 4 + 2 + 2 + 1
  = 9) and every output channel exactly once, the same shape gives the
  same plan, a block's shared memory fits the SM's 228 KB with the blocks
  an SM the plan states, and the grid fills the card;
- a numpy emulation of the upsample dgrad's TMA box reads (the map on the
  cotangent g stepping by 2 in rows and columns, the map on k22 as it
  lies), where every element carries its own id, gives each of the 16 taps
  exactly the g pixels and k22 entries the formula names, and zeros at the
  masked halo and past O and C;
- a plain emulation of the body's order (the plan's tiles, 64-channel K
  steps per tap read as zero-filled boxes, ``x + add`` summed in float32
  and rounded once before the products, float32 sums, bf16 rounding, the
  per-block column statistics in ascending rows and tiles; for the
  upsample dgrad, the 16 taps' boxes in order, 64-channel K steps, float32
  sums and one bf16 rounding) equals the port's plain versions and the JAX
  package's Pallas kernels run in interpret mode, at ragged shapes and at
  a main-path-shaped case at bs 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops import downsample_conv as jdown
from vqvae_from_gaussian_vae_tpu.ops import upsample_conv as jup
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up

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

# (mode, B, H, W, C, O): x (B, H, W, C), w (3, 3, C, O); for "up_dgrad" x
# is the upsample's input (dx's shape) and g (B, 2H, 2W, O)
MAIN = ([("fwd_add", 16, h, h, c, c) for h, c in [(256, 128), (128, 256), (64, 512)]]
        + [("dgrad", 16, h, h, c, c) for h, c in [(256, 128), (128, 256), (64, 512)]]
        + [("up_dgrad", 16, h, h, c, c) for h, c in [(32, 512), (64, 512), (128, 256)]])
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
    # the card tests' upsample shapes: a ragged tile, one pixel (every halo
    # masked), two N tiles, O = 96 and C = 136, ragged both ways
    ("up_dgrad", 2, 5, 7, 32, 128),
    ("up_dgrad", 1, 1, 1, 256, 512),
    ("up_dgrad", 1, 12, 20, 256, 128),
    ("up_dgrad", 2, 16, 16, 32, 512),
    ("up_dgrad", 1, 1, 9, 136, 96),
    ("up_dgrad", 2, 9, 21, 72, 160),
    ("up_dgrad", 2, 32, 32, 512, 512),
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
    mh, mw = (h, w) if mode == "up_dgrad" else (h // 2, w // 2)
    assert plan.tile_h * plan.tile_w == down.IGEMM_PIXELS
    tiles_w = -(-mw // plan.tile_w)
    assert plan.tiles == -(-mh // plan.tile_h) * tiles_w
    # the tiles cover the grid and overhang it by less than a tile
    assert 0 <= -(-mh // plan.tile_h) * plan.tile_h - mh < plan.tile_h
    assert 0 <= tiles_w * plan.tile_w - mw < plan.tile_w
    n = c if "dgrad" in mode else o
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
    seen = np.zeros((b, 2 * mh if mode == "dgrad" else mh, 2 * mw if mode == "dgrad" else mw,
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
        n = c if "dgrad" in mode else o
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


# --------------------------------------------------------------------------
# the upsample dgrad (mode kIgUpDgrad): 16 low-resolution taps over the
# cotangent g through a map that steps by 2, k22 read as it lies


def _tma_box(flat, dims, strides, box, elem, origin):
    """One TMA box read in tiled mode: along dim k the elements at
    origin[k] + elem[k] * i for i < box[k] / elem[k], zero where a
    coordinate falls outside [0, dims[k]); ``strides`` are the byte strides
    of dims 1..3 of a bf16 tensor.  An origin entry may be an array (the
    reads broadcast over it); returns (..., n3, n2, n1, n0)."""
    estrides = (1,) + tuple(s // 2 for s in strides)
    lin, inb = 0, True
    for k in range(4):
        n = -(-box[k] // elem[k])
        shape = [1, 1, 1, 1]
        shape[3 - k] = n
        coord = np.asarray(origin[k])[..., None, None, None, None] + \
            elem[k] * np.arange(n).reshape(shape)
        inb = inb & (coord >= 0) & (coord < dims[k])
        lin = lin + coord * estrides[k]
    return np.where(inb, flat[np.where(inb, lin, 0)], 0)


def _up_taps():
    """(t, di, dj, a, b) of the 16 taps in the kernel's order, t = 8 di +
    4 dj + 2 a + b."""
    return [(t, t >> 3, (t >> 2) & 1, (t >> 1) & 1, t & 1) for t in range(16)]


def _up_maps(plan, b, h, w, c, o):
    """The two maps ``csrc/upsample_bwd.cu`` encodes (``ig_nhwc_map`` on g
    with step 2, ``ig_weight_map`` on k22 as (O, C, 4, 4)): (dims, byte
    strides, box, element strides) each."""
    g = ((o, 2 * w, 2 * h, b), (2 * o, 2 * 2 * w * o, 2 * 2 * h * 2 * w * o),
         (64, 2 * plan.tile_w, 2 * plan.tile_h, 1), (1, 2, 2, 1))
    k22 = ((o, c, 4, 4), (2 * o, 2 * c * o, 2 * 4 * c * o), (64, plan.tile_n, 1, 1), (1, 1, 1, 1))
    return g, k22


def _up_origins(plan, b, h, w):
    """(sample, h0, w0) of every (sample, spatial tile), shaped (B, tiles)."""
    tiles_w = -(-w // plan.tile_w)
    mt = np.arange(plan.tiles)
    h0 = np.broadcast_to(mt // tiles_w * plan.tile_h, (b, plan.tiles))
    w0 = np.broadcast_to(mt % tiles_w * plan.tile_w, (b, plan.tiles))
    return np.broadcast_to(np.arange(b)[:, None], (b, plan.tiles)), h0, w0


def _up_box_a(gflat, plan, gmap, b, h, w, t, k0):
    """The A box of tap t and K step k0 for every (sample, tile): (B,
    tiles, 128 pixels, 64 channels) in the kernel's pixel order, read at
    the origin (k0, 2 w0 + 2 - dj - 2 b, 2 h0 + 2 - di - 2 a, sample)."""
    _, di, dj, a, bb = _up_taps()[t]
    smp, h0, w0 = _up_origins(plan, b, h, w)
    box = _tma_box(gflat, *gmap, (k0, 2 * w0 + 2 - dj - 2 * bb, 2 * h0 + 2 - di - 2 * a, smp))
    return box.reshape(b, plan.tiles, 128, 64)  # (sample, row, column, channel) of one tile


def _up_box_b(kflat, kmap, t, k0, n0):
    """The B box of tap t, K step k0 and N tile n0: (tile_n c rows, 64 o),
    read at the origin (k0, n0, 2 a + b, 2 di + dj)."""
    _, di, dj, a, bb = _up_taps()[t]
    return _tma_box(kflat, *kmap, (k0, n0, 2 * a + bb, 2 * di + dj))[0, 0]


UP_ID_CASES = [(2, 5, 7, 32, 128), (1, 1, 1, 256, 512), (1, 12, 20, 256, 128),
               (1, 1, 9, 136, 96), (2, 9, 21, 72, 160), (1, 32, 32, 512, 512)]


@pytest.mark.parametrize("b,h,w,c,o", UP_ID_CASES)
def test_up_dgrad_boxes_read_what_the_formula_names(b, h, w, c, o):
    """Every element of g and k22 carries its own id + 1 (0 is only ever the
    zero fill).  For every tap, K step, sample and tile, an on-grid pixel
    (i, j) of the A box holds g[2 (i - dr) + di, 2 (j - dc) + dj] where
    i - dr and j - dc lie in the image and zero where they do not (the
    masked halo) or past O; the B box holds k22[di, dj, a, b][n0 + row, k0
    + col], zero past C and O."""
    plan = down.igemm_plan("up_dgrad", b, h, w, c, o)
    gmap, kmap = _up_maps(plan, b, h, w, c, o)
    gflat = np.arange(1, b * 2 * h * 2 * w * o + 1, dtype=np.int64)
    g = np.pad(gflat.reshape(b, 2 * h, 2 * w, o), ((0, 0), (2, 2), (2, 2), (0, 64)))
    kflat = np.arange(1, 16 * c * o + 1, dtype=np.int64)
    k22 = np.pad(kflat.reshape(16, c, o), ((0, 0), (0, plan.tile_n), (0, 64)))
    smp, h0, w0 = _up_origins(plan, b, h, w)
    p = np.arange(128)
    i = h0[..., None] + p // plan.tile_w        # (B, tiles, 128)
    j = w0[..., None] + p % plan.tile_w
    on_grid = (i < h) & (j < w)
    for t, di, dj, a, bb in _up_taps():
        dr, dc = di + a - 1, dj + bb - 1
        inside = (i - dr >= 0) & (i - dr < h) & (j - dc >= 0) & (j - dc < w)
        # g padded by 2 rows and columns: the masked terms index the zeros
        rows = np.where(inside, 2 * (i - dr) + di, -2) + 2
        cols = np.where(inside, 2 * (j - dc) + dj, -2) + 2
        for k0 in range(0, o, 64):
            got = _up_box_a(gflat, plan, gmap, b, h, w, t, k0)
            want = g[smp[..., None], rows, cols][..., k0:k0 + 64]
            assert np.array_equal(got[on_grid], want[on_grid]), (t, k0)
            for n0 in range(0, c, plan.tile_n):
                assert np.array_equal(_up_box_b(kflat, kmap, t, k0, n0),
                                      k22[t, n0:n0 + plan.tile_n, k0:k0 + 64]), (t, k0, n0)


def _emulate_up_dgrad(g, k22):
    """The body's order for the upsample dgrad: per sample and spatial
    tile, the 16 taps in order and, in each, the 64-channel K steps of O:
    the A box of g times the B box of k22 (as k22[t][:, k0 .. k0 + 63]^T)
    summed in float32; then one bf16 rounding, dx at its own pixels."""
    b, h2, w2, o = g.shape
    h, w, c = h2 // 2, w2 // 2, k22.shape[-2]
    plan = down.igemm_plan("up_dgrad", b, h, w, c, o)
    gmap, _ = _up_maps(plan, b, h, w, c, o)
    gflat = g.float().numpy().reshape(-1)
    kp = torch.nn.functional.pad(k22.reshape(16, c, o).float(), (0, -o % 64))
    acc = torch.zeros((b, plan.tiles, 128, c))
    for t in range(16):
        for k0 in range(0, o, 64):
            box = torch.from_numpy(_up_box_a(gflat, plan, gmap, b, h, w, t, k0).astype(np.float32))
            acc = acc + box @ kp[t, :, k0:k0 + 64].t()
    return _untile(acc.to(torch.bfloat16), plan, h, w)


UP_CASES = [((2, 5, 7, 32), 128), ((1, 1, 1, 256), 512), ((1, 1, 9, 136), 96),
            ((2, 9, 21, 72), 160), ((2, 32, 32, 512), 512)]  # the last: main-path


@pytest.fixture(scope="module")
def up_dgrad_runs():
    runs = {}
    for i, (shape, o) in enumerate(UP_CASES):
        b, h, w, c = shape
        g = _bf16((b, 2 * h, 2 * w, o), 300 + i)
        k22 = up.phase_kernels(_bf16((3, 3, c, o), 400 + i, (9 * o) ** -0.5))
        runs[i] = (g, k22, _emulate_up_dgrad(g, k22), up.upsample_dgrad_plain(g, k22))
    return runs


@pytest.mark.parametrize("case", range(len(UP_CASES)))
def test_emulated_up_dgrad_matches_plain(up_dgrad_runs, case):
    _, _, dx, dx_plain = up_dgrad_runs[case]
    assert dx.shape == dx_plain.shape
    _close_bf16(dx, dx_plain)


@pytest.mark.parametrize("case,block", [(0, 5), (2, 1), (4, 8)])
def test_emulated_up_dgrad_matches_pallas(up_dgrad_runs, case, block):
    """The JAX kernel in row bands of `block` dx rows, on the same k22."""
    g, k22, dx, _ = up_dgrad_runs[case]
    want = jup._upsample_dgrad(_hwbc(g), jnp.swapaxes(jnp.asarray(k22.float().numpy()), -1, -2)
                               .astype(jnp.bfloat16), k22.shape[-2], block, True)
    _close_bf16(dx, _bhwc(want))
