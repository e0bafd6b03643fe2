"""The weight-gradient launch planner (``ops/downsample_conv.py``
``wgrad_plan``) and the order of the kernel's reduction, on the CPU.

The body (``csrc/conv_wgrad.cuh``) walks K steps, each one spatial tile of
one sample, in fixed runs (splits); each block sums its run in float32 and
a second pass adds the splits in ascending order.  Here:

- at every main-path shape of the three weight gradients and at ragged
  ones, the splits' tiles cover every pixel of the reduction exactly once,
  the same shape gives the same plan, the grid fills the card's 132 SMs
  (90% of them at least, and the last wave three quarters)
  and a block's shared memory fits the limit the plan states;
- a plain emulation of that order (the kernel's tile geometry, a float32
  partial per split, the splits in ascending order) equals the plain
  versions within 1e-5 of max |dw|, and the JAX package's Pallas wgrad
  kernels run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu.ops import conv3x3_train as jconv
from vqvae_from_gaussian_vae_tpu.ops import downsample_conv as jdown
from vqvae_from_gaussian_vae_tpu.ops import upsample_conv as jup
from vqvae_from_gaussian_vae_tpu_torch.ops import conv3x3_train as conv
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up

EMULATION_REL = 1e-5  # float32 sums of exact bf16 products in another order, over max |dw|
SM_SHARED = 233472    # bytes of shared memory on one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # bytes the hardware keeps per resident block
TAPS = {"same": 9, "down": 9, "up": 16}

# (mode, B, Mh, Mw, C, O): the pixel grid the reduction runs over
MAIN = ([("same", 16, h, h, c, o) for h, c, o in
         [(256, 128, 128), (256, 256, 128), (128, 128, 256), (128, 256, 256),
          (128, 512, 256), (64, 256, 512), (64, 512, 512), (32, 512, 512)]]
        + [("down", 16, h // 2, h // 2, c, c) for h, c in [(256, 128), (128, 256), (64, 512)]]
        + [("up", 16, h, h, c, c) for h, c in [(32, 512), (64, 512), (128, 256)]])
RAGGED = [
    ("same", 1, 20, 12, 136, 72),   # tiles ragged in H and W; C > 128, O < 128
    ("same", 2, 33, 17, 8, 8),
    ("same", 1, 1, 7, 72, 136),     # one pixel row
    ("same", 2, 32, 32, 512, 512),  # the smallest main-path grid at bs 2
    ("down", 3, 9, 17, 256, 128),
    ("down", 2, 100, 100, 256, 256),  # sd3unet's first downsample at 200x200
    ("up", 2, 5, 7, 32, 136),
    ("up", 1, 1, 1, 256, 512),
]


def _steps(plan):
    """(split, q) of every K step the kernel's blocks walk, q the step index."""
    for split in range(plan.splits):
        for q in range(split * plan.chunk, min((split + 1) * plan.chunk, plan.steps)):
            yield split, q


def _tile_origin(plan, q, mh, mw):
    """(b, i0, j0) of step q, as the producer computes it."""
    tiles_w = -(-mw // plan.tile_w)
    per_sample = -(-mh // plan.tile_h) * tiles_w
    b, rem = divmod(q, per_sample)
    return b, (rem // tiles_w) * plan.tile_h, (rem % tiles_w) * plan.tile_w


@pytest.mark.parametrize("mode,b,mh,mw,c,o", MAIN + RAGGED)
def test_plan_covers_every_pixel_once(mode, b, mh, mw, c, o):
    plan = down.wgrad_plan(TAPS[mode], b, mh, mw, c, o)
    assert plan.tile_h * plan.tile_w == down.WGRAD_STEP_PIXELS
    assert plan.splits * plan.chunk >= plan.steps > (plan.splits - 1) * plan.chunk  # none empty
    tiles = np.zeros((b, -(-mh // plan.tile_h), -(-mw // plan.tile_w)), dtype=np.int64)
    q = np.arange(plan.steps)
    split_of = np.minimum(q // plan.chunk, plan.splits - 1)
    assert np.array_equal(split_of, q // plan.chunk)
    bq, i0, j0 = _tile_origin(plan, q, mh, mw)
    np.add.at(tiles, (bq, i0 // plan.tile_h, j0 // plan.tile_w), 1)
    assert (tiles == 1).all()  # each tile of each sample walked once
    # the tiles cover the grid and overhang it by less than a tile
    assert 0 <= tiles.shape[1] * plan.tile_h - mh < plan.tile_h
    assert 0 <= tiles.shape[2] * plan.tile_w - mw < plan.tile_w
    if plan.steps <= 4096:  # and pixel by pixel where that is cheap
        seen = np.zeros((b, mh, mw), dtype=np.int64)
        for _, qq in _steps(plan):
            bb, ii, jj = _tile_origin(plan, qq, mh, mw)
            seen[bb, ii:ii + plan.tile_h, jj:jj + plan.tile_w] += 1
        assert (seen == 1).all()


def test_plans_repeat_fit_and_fill_the_card():
    for mode, b, mh, mw, c, o in MAIN + RAGGED:
        plan = down.wgrad_plan(TAPS[mode], b, mh, mw, c, o)
        assert plan == down.wgrad_plan(TAPS[mode], b, mh, mw, c, o)
        assert plan.tile_o == (256 if o % 256 == 0 else 128)
        assert plan.smem <= 232448  # a block's dynamic shared memory limit
        assert plan.blocks_per_sm * (plan.smem + BLOCK_RESERVED) <= SM_SHARED
        blocks = TAPS[mode] * -(-c // 128) * -(-o // plan.tile_o) * plan.splits
        if (mode, b, mh, mw, c, o) in MAIN:  # 90% of the SMs busy, the last wave 75% full
            slots = plan.blocks_per_sm * down.SMS
            waves = -(-blocks // slots)
            assert blocks >= 0.9 * down.SMS and blocks >= 0.75 * waves * slots, \
                (mode, mh, c, o, plan)
    assert down.wgrad_tile(1, 7) == (1, 64) and down.wgrad_tile(32, 32) == (2, 32)


def _tap_views(mode, x, g):
    """[(X_t, G_t)] in float32, each (B, Mh, Mw, channels): what tap t's
    tensor maps read (zero outside the image)."""
    _, h, w, _ = x.shape
    xf, gf = x.float(), g.float()
    if mode == "same":
        xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
        return [(xp[:, r:r + h, s:s + w], gf) for r in range(3) for s in range(3)]
    if mode == "down":
        xp = F.pad(xf, (0, 0, 0, 1, 0, 1))
        return [(xp[:, r:r + h:2, s:s + w:2], gf) for r in range(3) for s in range(3)]
    xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
    return [(xp[:, di + a:di + a + h, dj + bb:dj + bb + w], gf[:, di::2, dj::2])
            for di in (0, 1) for dj in (0, 1) for a in (0, 1) for bb in (0, 1)]


def _emulate(mode, x, g):
    """The kernel's order: per tap, the planner's spatial tiles zero-padded
    to whole tiles, a float32 partial per split over its run of steps, the
    splits summed in ascending order."""
    views = _tap_views(mode, x, g)
    b, mh, mw, c = views[0][0].shape
    o = g.shape[-1]
    plan = down.wgrad_plan(TAPS[mode], b, mh, mw, c, o)
    th, tw = plan.tile_h, plan.tile_w
    n_th, n_tw = -(-mh // th), -(-mw // tw)

    def steps(t):  # (B, Mh, Mw, ch) -> (steps, th * tw, ch) in the kernel's step order
        t = F.pad(t, (0, 0, 0, n_tw * tw - mw, 0, n_th * th - mh))
        t = t.reshape(b, n_th, th, n_tw, tw, t.shape[-1]).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(plan.steps, th * tw, t.shape[-1])

    out = []
    for xt, gt in views:
        xs, gs = steps(xt), steps(gt)
        total = torch.zeros((c, o), dtype=torch.float32)
        for split in range(plan.splits):
            run = slice(split * plan.chunk, min((split + 1) * plan.chunk, plan.steps))
            total = total + xs[run].reshape(-1, c).t() @ gs[run].reshape(-1, o)
        out.append(total)
    return torch.stack(out), plan


def _bf16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _close_rel(got, want, tol):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("mode,x_shape,o", [
    ("same", (1, 20, 12, 136), 72),
    ("same", (2, 33, 17, 8), 8),
    ("same", (1, 1, 7, 72), 136),
    ("down", (3, 18, 34, 72), 136),
    ("down", (2, 10, 14, 8), 72),
    ("up", (2, 5, 7, 32), 136),
    ("up", (1, 9, 3, 8), 8),
    ("up", (3, 6, 10, 16), 24),
])
def test_emulated_kernel_order_matches_plain(mode, x_shape, o):
    b, h, w, c = x_shape
    g_shape = {"same": (b, h, w, o), "down": (b, h // 2, w // 2, o),
               "up": (b, 2 * h, 2 * w, o)}[mode]
    x, g = _bf16(x_shape, sum(x_shape)), _bf16(g_shape, o)
    got, plan = _emulate(mode, x, g)
    plain = {"same": conv.conv3x3_wgrad_plain, "down": down.downsample_wgrad_plain,
             "up": up.upsample_wgrad_plain}[mode](x, g)
    _close_rel(got, plain.reshape(got.shape), EMULATION_REL)


def _hwbc(t):
    return jnp.transpose(jnp.asarray(t.float().numpy()), (1, 2, 0, 3))


@pytest.mark.parametrize("mode,x_shape,o,block", [  # each plans several splits
    ("same", (4, 16, 16, 8), 16, 4),
    ("down", (4, 16, 16, 8), 16, 2),
    ("up", (3, 6, 10, 16), 24, 3),
])
def test_emulated_kernel_order_matches_pallas(mode, x_shape, o, block):
    b, h, w, c = x_shape
    g_shape = {"same": (b, h, w, o), "down": (b, h // 2, w // 2, o),
               "up": (b, 2 * h, 2 * w, o)}[mode]
    x, g = _bf16(x_shape, 7 + o), _bf16(g_shape, 11 + o)
    got, plan = _emulate(mode, x, g)
    assert plan.splits > 1
    jax_fn = {"same": jconv._conv3x3_wgrad, "down": jdown._downsample_wgrad,
              "up": jup._upsample_wgrad}[mode]
    want = np.array(jax_fn(_hwbc(x), _hwbc(g), block, True))
    _close_rel(got, torch.from_numpy(want).reshape(got.shape), EMULATION_REL)
