"""The Hopper implicit-GEMM body's two newest modes on the CPU: the upsample
forward (``kIgUpFwd``, plan modes "up_fwd" and "up_fwd_add") and the fused
GroupNorm + swish conv (``kIgSameGn``, plan mode "same_gn"), through their
launch planner (``ops/downsample_conv.py`` ``igemm_plan``) and the order of
their arithmetic.

- At every main-path shape (the three sd3unet upsamples, the eight resblock
  convs of the fused-inference step) and at ragged ones, the blocks cover
  every output pixel (of all four phases for the upsample) and every output
  channel exactly once, a block's shared memory fits the SM with the blocks
  an SM the plan states, the main-path grids fill the card, the fused GN
  conv's tile is near square (8 x 16) and its halo box is one TMA box.
- A plain emulation of each mode's order equals the port's plain version
  and the JAX package's Pallas kernel run in interpret mode:
  the upsample forward's four phases of four zero-filled boxes of x (or of
  x + add, rounded once), 64-channel K steps, float32 sums, the bf16 bias,
  one rounding, and the column statistics of each block in ascending rows
  then the (phase, tile) partials in ascending order; the fused GN conv's
  halo box transformed once per K step (swish(x scale + shift) in float32,
  rounded to bf16, 0 off the image and past C), its nine shifted windows
  times the weights in float32, + the float32 bias and the residual, one
  rounding.  Cases include ragged grids, C = 32 (half a K step) and a
  residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops import fused_gn_conv as jfused
from vqvae_from_gaussian_vae_tpu.ops import upsample_conv as jup
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import fused_gn_conv as fgc
from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up

# y: float32 sums of exact bf16 products in another order, then one bf16
# rounding: at most one bf16 ulp apart (the card tests' bar)
BF16_ATOL = BF16_RTOL = 1e-2
STATS_RTOL = 1e-5  # the emulated statistics vs a float64 reduce of the emulated y
# the statistics against the JAX kernel's, over sum |y| (sum y^2): its y may
# differ from the emulation's by one bf16 ulp in a few elements
STATS_JAX_RTOL = 1e-4
SM_SHARED = 233472      # bytes of shared memory on one H100 SM (228 KB)
BLOCK_RESERVED = 1024   # bytes the hardware keeps per resident block
BLOCK_SMEM_MAX = 232448  # a block's dynamic shared memory limit

# (mode, B, H, W, C, O): x (B, H, W, C), w (3, 3, C, O)
MAIN = ([("up_fwd", 16, 32, 32, 512, 512), ("up_fwd_add", 16, 64, 64, 512, 512),
         ("up_fwd_add", 16, 128, 128, 256, 256)]
        + [("same_gn", 16, h, h, c, o) for h, c, o in
           [(256, 128, 128), (256, 256, 128), (128, 128, 256), (128, 256, 256),
            (128, 512, 256), (64, 256, 512), (64, 512, 512), (32, 512, 512)]])
RAGGED = [
    ("up_fwd", 2, 5, 7, 32, 128),        # one ragged tile a phase
    ("up_fwd_add", 1, 12, 20, 64, 256),  # two tiles; N tile 256
    ("up_fwd_add", 2, 16, 16, 32, 128),
    ("up_fwd", 1, 1, 1, 32, 128),        # one pixel: every tap but one off the image
    ("up_fwd", 2, 9, 21, 96, 384),       # three N tiles of 128
    ("same_gn", 2, 16, 24, 64, 128),
    ("same_gn", 1, 32, 32, 128, 64),     # O < a tile
    ("same_gn", 2, 8, 40, 96, 136),      # ragged N: two tiles, the second 8 wide
    ("same_gn", 1, 1, 1, 32, 8),         # one pixel: every neighbour is padding
    ("same_gn", 2, 9, 21, 32, 256),      # ragged both ways; C = 32; N tile 256
    ("same_gn", 1, 200, 200, 128, 128),  # sd3unet's first resblock at 200x200
]


def _blocks(plan, mode, b):
    """(phase, sample, spatial tile, N tile) of every block, decoded from its
    index as the kernel does: the N tile fastest, then the upsample
    forward's phase, the tile, the sample."""
    bid = np.arange(plan.grid)
    nt = bid % plan.n_tiles
    rest = bid // plan.n_tiles
    phase = np.zeros_like(rest)
    if mode.startswith("up_fwd"):
        phase, rest = rest % 4, rest // 4
    mt = rest % plan.tiles
    return phase, rest // plan.tiles, mt, nt


@pytest.mark.parametrize("mode,b,h,w,c,o", MAIN + RAGGED)
def test_plan_covers_every_output_once(mode, b, h, w, c, o):
    plan = down.igemm_plan(mode, b, h, w, c, o)
    assert plan.tile_h * plan.tile_w == down.IGEMM_PIXELS
    tiles_w = -(-w // plan.tile_w)
    assert plan.tiles == -(-h // plan.tile_h) * tiles_w
    assert plan.n_tiles * plan.tile_n >= o > (plan.n_tiles - 1) * plan.tile_n
    upf = mode.startswith("up_fwd")
    assert plan.phases == (4 if upf else 1)
    assert plan.partials == (4 * plan.tiles if upf else 0)
    phase, bb, mt, nt = _blocks(plan, mode, b)
    assert bb.max() == b - 1 and phase.max() == plan.phases - 1
    p = np.arange(down.IGEMM_PIXELS)
    rows = (mt // tiles_w * plan.tile_h)[:, None] + p // plan.tile_w
    cols = (mt % tiles_w * plan.tile_w)[:, None] + p % plan.tile_w
    keep = (rows < h) & (cols < w)
    if upf:  # the phase's pixel of y (2H, 2W)
        rows, cols = 2 * rows + (phase // 2)[:, None], 2 * cols + (phase % 2)[:, None]
    k = 2 if upf else 1
    seen = np.zeros((b, k * h, k * w, plan.n_tiles), dtype=np.int64)
    np.add.at(seen, (np.broadcast_to(bb[:, None], rows.shape)[keep], rows[keep], cols[keep],
                     np.broadcast_to(nt[:, None], rows.shape)[keep]), 1)
    assert (seen == 1).all()


def test_plans_repeat_fit_and_fill_the_card():
    for mode, b, h, w, c, o in MAIN + RAGGED:
        plan = down.igemm_plan(mode, b, h, w, c, o)
        assert plan == down.igemm_plan(mode, b, h, w, c, o)
        assert plan.tile_n == (256 if o % 256 == 0 else 128)
        gn = mode == "same_gn"
        one = gn or mode == "up_fwd_add" or plan.tile_n == 256
        assert plan.blocks_per_sm == (1 if one else 2)
        assert plan.stages == (3 if plan.blocks_per_sm == 2 or
                               (mode == "up_fwd_add" and plan.tile_n == 256) else 4)
        assert plan.smem <= BLOCK_SMEM_MAX
        assert plan.blocks_per_sm * (plan.smem + BLOCK_RESERVED) <= SM_SHARED
        # the epilogue stages the 128 x tile_n bf16 tile (and two rows of
        # float32 partial sums) in the ring
        assert plan.smem - 1024 >= 128 * plan.tile_n * 2 + 2 * plan.tile_n * 4
        if gn:  # a near-square tile: the halo box is 1.4 tiles, not 3.0 (1 x 128)
            assert (plan.tile_h, plan.tile_w) == down.IGEMM_GN_TILE == (8, 16)
            box = (plan.tile_h + 2) * (plan.tile_w + 2)
            assert box / 128 < 1.41 and max(plan.tile_h, plan.tile_w) + 2 <= 256
            # three halo buffers of one 64-channel box each, 1024-byte aligned
            assert down.IGEMM_HALO_BYTES % 1024 == 0 and down.IGEMM_HALO_BYTES >= box * 128
            assert plan.smem >= 3 * down.IGEMM_HALO_BYTES + plan.stages * plan.tile_n * 128
        if (mode, b, h, w, c, o) in MAIN:  # at least one full wave
            assert plan.grid >= plan.blocks_per_sm * down.SMS, (mode, h, plan)


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


def _column_stats(yv, tile_n):
    """The epilogue's statistics of one block's staged rows (..., 128, o):
    a column over its rows in ascending order, in two parts of 64 rows at
    tile_n 128 added in order, one part at 256."""
    parts = 2 if tile_n == 128 else 1
    per = 128 // parts
    total = None
    for part in range(parts):
        s_ = torch.zeros(yv.shape[:-2] + yv.shape[-1:])
        ss_ = torch.zeros_like(s_)
        for r in range(part * per, (part + 1) * per):
            v = yv[..., r, :]
            s_, ss_ = s_ + v, ss_ + v * v
        total = (s_, ss_) if total is None else (total[0] + s_, total[1] + ss_)
    return total


def _emulate_up_fwd(x, add, w, bias):
    """The upsample forward's order: per phase (di, dj), tap (a, b) and
    64-channel step, the zero-filled box of x (or x + add, rounded once) at
    (h0 + di + a - 1, w0 + dj + b - 1) times k22[di, dj, a, b] in float32;
    + the bf16 bias, rounded; the column statistics of each block, then the
    partials of each sample in ascending (phase, tile) order."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    plan = down.igemm_plan("up_fwd" if add is None else "up_fwd_add", b, h, wd, c, o)
    th, tw = plan.tile_h, plan.tile_w
    rows, cols = -(-h // th) * th, -(-wd // tw) * tw
    kc = -(-c // 64)
    a = x.float() if add is None else (x.float() + add.float()).to(torch.bfloat16).float()
    ap = torch.zeros((b, rows + 2, cols + 2, 64 * kc))  # index i + 1: row i; the zero fill
    ap[:, 1:1 + h, 1:1 + wd, :c] = a
    k22 = torch.zeros((2, 2, 2, 2, 64 * kc, o))
    k22[..., :c, :] = up.phase_kernels(w.to(torch.bfloat16)).float()
    on_grid = _tiles(torch.nn.functional.pad(torch.ones((1, h, wd, 1)),
                                             (0, 0, 0, cols - wd, 0, rows - h)), plan)
    y = torch.zeros((b, 2 * h, 2 * wd, o), dtype=torch.bfloat16)
    partials = []
    for phase in range(4):
        di, dj = divmod(phase, 2)
        acc = torch.zeros((b, plan.tiles, 128, o))
        for ta in range(2):
            for tb in range(2):
                box = _tiles(ap[:, di + ta:di + ta + rows, dj + tb:dj + tb + cols], plan)
                for k in range(kc):
                    acc = acc + box[..., 64 * k:64 * (k + 1)] @ k22[di, dj, ta, tb,
                                                                    64 * k:64 * (k + 1)]
        yp = (acc + bias.to(torch.bfloat16).float()).to(torch.bfloat16)
        y[:, di::2, dj::2] = _untile(yp, plan, h, wd)
        partials.append(_column_stats(yp.float() * on_grid, plan.tile_n))
    stats = torch.zeros((b, 2, o))
    for s_, ss_ in partials:  # conv_stats_reduce_kernel: slot = phase x tiles + tile
        for p in range(plan.tiles):
            stats = stats + torch.stack([s_[:, p], ss_[:, p]], dim=1)
    return y, stats


def _emulate_same_gn(x, gamma, beta, w, bias, res):
    """The fused GN conv's order: h = swish(x scale + shift) as the kernel
    writes it, h / (1 + exp(-h)) in float32 (the kernel's division is the
    fast one, its error far below the rounding), rounded to bf16, in each
    tile's halo box (0 off the image and past C: the pad after the
    transform); per 64-channel step and tap (r, s), the box's window at
    (r, s) times w[r, s] in float32; + the float32 bias + the residual, one
    rounding."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    plan = down.igemm_plan("same_gn", b, h, wd, c, o)
    th, tw = plan.tile_h, plan.tile_w
    rows, cols = -(-h // th) * th, -(-wd // tw) * tw
    kc = -(-c // 64)
    scale, shift = fgc.gn_affine(x, gamma, beta)
    v = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    hv = (v / (1.0 + torch.exp(-v))).to(torch.bfloat16).float()
    hp = torch.zeros((b, rows + 2, cols + 2, 64 * kc))  # index i + 1: row i; the halo's zeros
    hp[:, 1:1 + h, 1:1 + wd, :c] = hv
    wp = torch.zeros((3, 3, 64 * kc, o))
    wp[:, :, :c] = w.to(torch.bfloat16).float()
    acc = torch.zeros((b, plan.tiles, 128, o))
    for k in range(kc):
        for t in range(9):
            r, s = divmod(t, 3)
            box = _tiles(hp[:, r:r + rows, s:s + cols], plan)
            acc = acc + box[..., 64 * k:64 * (k + 1)] @ wp[r, s, 64 * k:64 * (k + 1)]
    y = _untile(acc, plan, h, wd) + bias.float()
    if res is not None:
        y = y + res.float()
    return y.to(torch.bfloat16)


def _bf16(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(
        torch.bfloat16)


def _close_bf16(got, want):
    d = (got.float() - want.float()).abs()
    assert bool((d <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()), float(d.max())


def _stats_close(stats, y, rtol):
    yd = y.double().flatten(1, 2)
    ref = torch.stack([yd.sum(1), (yd * yd).sum(1)], dim=1)
    scale = torch.stack([yd.abs().sum(1), (yd * yd).sum(1)], dim=1).clamp_min(1e-30)
    assert float(((stats.double() - ref).abs() / scale).max()) <= rtol


UP_CASES = [((2, 5, 7, 32), 128, False), ((1, 12, 20, 64), 256, True),
            ((2, 9, 21, 96), 384, True), ((2, 32, 32, 512), 512, False)]  # the last: main-path
GN_CASES = [((2, 9, 21, 32), 256, True),    # ragged both ways, C = 32, residual
            ((1, 16, 24, 128), 64, False),  # two K steps, O < a tile
            ((2, 8, 40, 96), 136, True),    # a K step half past C; ragged N
            ((1, 1, 1, 32), 8, False),      # one pixel: every neighbour is padding
            ((2, 32, 32, 512), 512, True)]  # the last: main-path (32^2, 512 -> 512) at bs 2


@pytest.fixture(scope="module")
def up_runs():
    """Each upsample case's inputs, emulation and plain version, once."""
    runs = {}
    for i, (shape, o, with_add) in enumerate(UP_CASES):
        c = shape[-1]
        x = _bf16(shape, 10 * i)
        add = _bf16(shape, 10 * i + 1) if with_add else None
        w = _bf16((3, 3, c, o), 10 * i + 2, (9 * c) ** -0.5)
        bias = _bf16((o,), 10 * i + 3, 0.1).float()
        runs[i] = (x, add, w, bias, _emulate_up_fwd(x, add, w, bias),
                   up.upsample_nearest_conv3x3_gn_plain(x, w, bias, add))
    return runs


@pytest.fixture(scope="module")
def gn_runs():
    runs = {}
    for i, (shape, o, residual) in enumerate(GN_CASES):
        b, h, wd, c = shape
        x = _bf16(shape, 100 + 10 * i, 2.0, 0.3)
        gamma = 1 + 0.3 * _bf16((c,), 101 + 10 * i).float()
        beta = 0.3 * _bf16((c,), 102 + 10 * i).float()
        w = _bf16((3, 3, c, o), 103 + 10 * i, (9 * c) ** -0.5).float()
        bias = 0.1 * _bf16((o,), 104 + 10 * i).float()
        res = _bf16((b, h, wd, o), 105 + 10 * i) if residual else None
        args = (x, gamma, beta, w, bias, res)
        runs[i] = (args, _emulate_same_gn(*args), fgc.fused_gn_swish_conv_plain(*args))
    return runs


@pytest.mark.parametrize("case", range(len(UP_CASES)))
def test_emulated_up_fwd_matches_plain(up_runs, case):
    _, _, _, _, (y, stats), (y_plain, stats_plain) = up_runs[case]
    assert y.shape == y_plain.shape
    _close_bf16(y, y_plain)
    _stats_close(stats, y, STATS_RTOL)
    _stats_close(stats_plain, y, STATS_JAX_RTOL)


@pytest.mark.parametrize("case", range(len(GN_CASES)))
def test_emulated_same_gn_matches_plain(gn_runs, case):
    _, y, y_plain = gn_runs[case]
    assert y.shape == y_plain.shape and y.dtype == y_plain.dtype == torch.bfloat16
    _close_bf16(y, y_plain)


def _hwbc(t):
    return jnp.transpose(jnp.asarray(t.float().numpy()), (1, 2, 0, 3)).astype(jnp.bfloat16)


def _bhwc(a):
    return torch.from_numpy(np.asarray(jnp.transpose(a, (2, 0, 1, 3)).astype(jnp.float32)))


@pytest.mark.parametrize("case,block", [(0, 1), (1, 4), (2, 3)])
def test_emulated_up_fwd_matches_pallas(up_runs, case, block):
    """The JAX kernel in row bands of `block` input rows, on the same
    bf16-valued weights (its phase kernels summed in float32, as the
    port's)."""
    x, add, w, bias, (y, stats), _ = up_runs[case]
    yt, jstats = jup._upsample_conv_hwbc(
        _hwbc(x), None if add is None else _hwbc(add), jnp.asarray(w.float().numpy()),
        jnp.asarray(bias.numpy()), block, True, True)
    y_jax = _bhwc(yt)
    _close_bf16(y, y_jax)
    _stats_close(stats, y_jax, STATS_JAX_RTOL)
    _stats_close(torch.from_numpy(np.asarray(jnp.sum(jstats, axis=0))), y, STATS_JAX_RTOL)


@pytest.mark.parametrize("case,block", [(0, 3), (1, 8), (2, 4), (3, 1)])
def test_emulated_same_gn_matches_pallas(gn_runs, case, block):
    """The JAX kernel in row bands of `block` rows, bf16, with its own
    GroupNorm affine: within one bf16 ulp."""
    (x, gamma, beta, w, bias, res), y, _ = gn_runs[case]
    j = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    want = jfused.fused_gn_swish_conv(
        j(x).astype(jnp.bfloat16), j(gamma), j(beta), j(w), j(bias), block_h=block,
        interpret=True, residual=None if res is None else j(res).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    _close_bf16(y, torch.from_numpy(np.asarray(want.astype(jnp.float32))))


def test_same_gn_pads_after_the_transform():
    """A tap off the image adds 0, not swish(shift): with shift large, a
    transform of the zero fill would move every edge pixel; here only
    interior taps count, as in the plain version."""
    x = torch.zeros((1, 3, 5, 32), dtype=torch.bfloat16)
    gamma, beta = torch.ones(32), torch.full((32,), 4.0)
    w = torch.ones((3, 3, 32, 8)) / 64
    y = _emulate_same_gn(x, gamma, beta, w, torch.zeros(8), None)
    taps = torch.nn.functional.conv2d(torch.ones((1, 1, 3, 5)), torch.ones((1, 1, 3, 3)),
                                      padding=1)[0, 0]  # in-image taps of each pixel
    want = (taps * 32 / 64 * float(torch.tensor(4.0) * torch.sigmoid(torch.tensor(4.0))))
    _close_bf16(y[0, ..., 0], want)
    _close_bf16(y, fgc.fused_gn_swish_conv_plain(x, gamma, beta, w, torch.zeros(8)))
