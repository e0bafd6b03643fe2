"""The flash forward's launch planner (``ops/flash_attention.py``
``flash_fwd_plan``) and the order of the wgmma bodies' arithmetic
(``csrc/flash_fwd_sm90.cuh`` at D = 64 and 128,
``csrc/flash_fwd_sm90_wide.cuh`` at D = 256 and 512), on the CPU.

Both bodies read q, k and v through 4-D TMA maps and run an online softmax
over the key tiles: 192 q rows (D = 64) or 128 (D = 128) against 128-key
tiles, or, in the wide body, 64 q rows against 64-key tiles, the output's
columns split over two consumer warpgroups that each form the whole score
tile.  Here:

- at the main-path shapes and at ragged ones, for each layout (head-major,
  token-major, packed at token stride 3C) and head dim, a numpy emulation
  of TMA's box reads over the plan's maps (zero fill out of bounds) gives
  back exactly each (b, h)'s q, k and v, with zeros past L and nothing from
  a neighbouring head or sample (every element of the inputs carries its
  own id);
- the same shape gives the same plan, and every plan fits the shared
  memory it states, under a block's 232,448 bytes;
- a plain emulation of the kernels' order (the plan's q tiles and key
  tiles, the online rescale, bf16 p, float32 sums, the -inf mask of the
  last key tile; in the wide body each half of o from its own half of V)
  matches the port's plain versions within 2e-2 (o) and 1e-3 (z), the
  card's bars, and the JAX package's packed and unpacked ``_fwd_impl``
  (interpret mode) and head-major op (TPU interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops import flash_attention as jfl
from vqvae_from_gaussian_vae_tpu.ops.flash_blc import (
    _fwd_call, _fwd_hpb, _fwd_res_call, _fwd_res_call_packed)
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl

FLASH_ATOL = 2e-2  # the JAX package's bf16 attention bar
Z_ATOL = 1e-3      # the log-normaliser: float32 sums in another order
F32_REL = 1e-5     # float32 operands: float32 sums in another order, over the largest value
SMEM_LIMIT = 232448  # a block's dynamic shared memory on an H100
SM_SHARED = 233472   # one SM's shared memory; the hardware keeps 1024 bytes a block

# (layout, B, H, Lq, Lk, D): the main-path shapes (the packed bsqvit
# attention, the head-major op's shapes), then ragged ones
MAIN = [("packed", 16, 12, 1024, 1024, 64), ("head_major", 1, 12, 8192, 8192, 64),
        ("head_major", 8, 12, 1024, 1024, 64), ("head_major", 2, 4, 512, 512, 64)]
RAGGED = ([("head_major", b, h, lq, lk, 64) for b, h, lq, lk in
           [(1, 1, 1, 77), (2, 2, 77, 1), (2, 2, 200, 328), (1, 12, 328, 200)]]
          + [("head_major", 2, 2, 1, 300, 128), ("head_major", 1, 2, 200, 328, 128)]
          + [("token_major", 1, 2, 64, 64, 64), ("token_major", 2, 12, 192, 192, 64),
             ("token_major", 2, 1, 64, 64, 128)]
          + [("packed", 1, 1, 64, 64, 64), ("packed", 2, 12, 192, 192, 64),
             ("packed", 2, 4, 64, 64, 128), ("packed", 1, 2, 328, 328, 64)])
# the wide body (D = 256, 512): the UNet AttnBlock's shape, the head-major
# op's D = 256 shape, a packed one
WIDE = [("token_major", 16, 1, 1024, 1024, 512), ("head_major", 2, 2, 200, 328, 256),
        ("packed", 2, 1, 64, 64, 256)]
# the wide body's box reads, at shapes small enough for id arrays
WIDE_BOXES = [("head_major", 2, 2, 200, 328, 256), ("head_major", 1, 1, 1, 77, 512),
              ("head_major", 1, 2, 130, 64, 512), ("token_major", 2, 1, 256, 256, 512),
              ("token_major", 1, 2, 128, 128, 256), ("packed", 2, 1, 64, 64, 256),
              ("packed", 1, 2, 192, 192, 512)]


def _plan(layout, b, h, lq, lk, d):
    stride = {"head_major": 0, "token_major": h * d, "packed": 3 * h * d}[layout]
    return fa.flash_fwd_plan(layout, b, h, lq, lk, d, stride)


def _ids(layout, b, h, lq, lk, d):
    """(flat storage, {name: (B, H, L, D) view}) where every element's value
    is its own id + 1 (so 0 is only ever the zero fill)."""
    c = h * d
    if layout == "head_major":
        nq, nk = b * h * lq * d, b * h * lk * d
        flat = {"q": np.arange(1, nq + 1, dtype=np.int64), "k": np.arange(1, nk + 1) + nq,
                "v": np.arange(1, nk + 1) + nq + nk}
        views = {"q": flat["q"].reshape(b, h, lq, d), "k": flat["k"].reshape(b, h, lk, d),
                 "v": flat["v"].reshape(b, h, lk, d)}
        return flat, views
    if layout == "token_major":
        n = b * lq * c
        flat = {t: np.arange(1, n + 1, dtype=np.int64) + i * n for i, t in enumerate("qkv")}
        views = {t: flat[t].reshape(b, lq, h, d).transpose(0, 2, 1, 3) for t in "qkv"}
        return flat, views
    qkv = np.arange(1, b * lq * 3 * c + 1, dtype=np.int64).reshape(b, lq, 3 * c)
    flat = {t: qkv.reshape(-1) for t in "qkv"}
    views = {t: qkv[..., i * c:(i + 1) * c].reshape(b, lq, h, d).transpose(0, 2, 1, 3)
             for i, t in enumerate("qkv")}
    return flat, views


def _box(flat, m, origin):
    """One TMA box read of map m at origin (each coordinate an int or an
    array over (B, H)): (..., box[3], box[2], box[1], box[0]) elements,
    zero where any coordinate falls outside m.dims."""
    estrides = (1,) + tuple(s // 2 for s in m.strides)
    assert all(s % 2 == 0 and s % 16 == 0 for s in m.strides)
    lin, inb = m.offset, True
    for k in range(4):
        shape = [1, 1, 1, 1]
        shape[3 - k] = m.box[k]
        coord = np.asarray(origin[k])[..., None, None, None, None] + \
            np.arange(m.box[k]).reshape(shape)
        inb = inb & (coord >= 0) & (coord < m.dims[k])
        lin = lin + coord * estrides[k]
    assert int(np.where(inb, lin, 0).max()) < flat.size  # never past the buffer
    return np.where(inb, flat[np.where(inb, lin, 0)], 0)


def _tiles(flat, plan, which, b, h, length, d):
    """What the kernel's copies put in shared memory for every (b, h):
    (B, H, tiles * rows, D), the tiles stacked, chunk by chunk."""
    rows = plan.q_rows if which == 0 else plan.k_rows
    m = plan.maps[which]
    bb, hh = np.meshgrid(np.arange(b), np.arange(h), indexing="ij")
    out = []
    for t in range(-(-length // rows)):
        chunks = []
        for c in range(d // fa.SWIZZLE_COLS):
            box = _box(flat, m, plan.coords(c, t * rows, bb, hh))
            chunks.append(box.reshape(b, h, rows, fa.SWIZZLE_COLS))
        out.append(np.concatenate(chunks, axis=-1))
    return np.concatenate(out, axis=2)


@pytest.mark.parametrize("layout,b,h,lq,lk,d", MAIN + RAGGED + WIDE_BOXES)
def test_plan_boxes_read_each_head_exactly(layout, b, h, lq, lk, d):
    plan = _plan(layout, b, h, lq, lk, d)
    assert plan.body == ("wgmma_wide" if d in fa.WIDE_HEAD_DIMS else "wgmma")
    assert plan.grid == (-(-lq // plan.q_rows), b * h)
    assert plan.row_dim == (1 if layout == "head_major" else 2)
    flat, views = _ids(layout, b, h, lq, lk, d)
    for which, (name, length) in enumerate((("q", lq), ("k", lk), ("v", lk))):
        got = _tiles(flat[name], plan, which, b, h, length, d)
        want = np.zeros_like(got)
        want[:, :, :length] = views[name]
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("layout,b,h,lq,lk,d", MAIN + RAGGED + WIDE)
def test_plans_repeat_and_fit(layout, b, h, lq, lk, d):
    plan = _plan(layout, b, h, lq, lk, d)
    stride = {"head_major": 0, "token_major": h * d, "packed": 3 * h * d}[layout]
    assert plan == fa.flash_fwd_plan.__wrapped__(layout, b, h, lq, lk, d, stride)
    assert list(plan.as_array()) == list(_plan(layout, b, h, lq, lk, d).as_array())
    assert plan.smem <= SMEM_LIMIT and plan.smem + 1024 <= SM_SHARED
    assert plan.key_mask == (lk % plan.k_rows != 0)
    assert plan.grid == (-(-lq // plan.q_rows), b * h)
    if d in fa.WGMMA_HEAD_DIMS:
        wgs = fa.FWD_WARPGROUPS[d]
        assert (plan.q_rows, plan.k_rows, plan.stages, plan.threads) == \
            (64 * wgs, 128, 3, 128 * (wgs + 1))
        assert plan.smem == ((64 * wgs + 2 * 3 * 128) * d * 2 + 80 + 1024)
    else:  # the wide body: 64 q rows, 64-key K and V tiles, 2 stages at D = 256, 1 at 512
        stages = {256: 2, 512: 1}[d]
        assert plan.body == "wgmma_wide"
        assert (plan.q_rows, plan.k_rows, plan.stages, plan.threads) == (64, 64, stages, 384)
        assert plan.smem == (64 + 2 * stages * 64) * d * 2 + (1 + 4 * stages) * 8 + 1024
    for m in plan.maps:  # TMA: 16-byte strides and bases, boxes of <= 256, 128 bytes wide
        assert all(s % 16 == 0 for s in m.strides) and (2 * m.offset) % 16 == 0
        assert max(m.box) <= 256 and m.box[0] * 2 == 128
    arr = list(plan.as_array())
    assert len(arr) == 49 and arr[0] == {"wgmma": 1, "wgmma_wide": 2}[plan.body]
    assert arr[4:6] == list(plan.grid)


def test_plan_refuses_what_no_body_takes():
    for args in [("head_major", 1, 1, 128, 128, 96), ("token_major", 1, 1, 128, 64, 64, 64),
                 ("packed", 1, 1, 128, 128, 64, 32), ("blc", 1, 1, 128, 128, 64),
                 ("head_major", 1, 1, 0, 128, 64)]:
        with pytest.raises(ValueError):
            fa.flash_fwd_plan(*args)


def emulate_fwd(q, k, v, scale, plan):
    """The wgmma bodies' order on (B, H, Lq, D) q and (B, H, Lk, D) k, v:
    q rows in tiles of plan.q_rows and keys in tiles of plan.k_rows, both
    zero-filled past their length; per key tile, scores in float32 over
    the whole D (in the wide body each of the two warpgroups forms them
    alike), the keys past Lk of the last tile at -inf, the running max, the
    rescale exp(m_old - m_new), p = exp(s - m) rounded to v's dtype for the
    P.V product (float32 sums; in the wide body each half of o from its
    own half of V), the row sum over the float32 p; 1/sum once at the end.
    Returns (o in v's dtype, z float32)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    rq, rk = plan.q_rows, plan.k_rows
    nq, nk = -(-lq // rq), -(-lk // rk)
    pad = lambda t, n: torch.nn.functional.pad(t.float(), (0, 0, 0, n - t.shape[2]))  # noqa: E731
    qp, kp, vp = pad(q, nq * rq), pad(k, nk * rk), pad(v, nk * rk)
    # the q tiles' blocks are independent: each a slice of a batch dimension
    qt = qp.reshape(b, h, nq, rq, d)
    o = torch.zeros((b, h, nq, rq, d))
    m = torch.full((b, h, nq, rq), -torch.inf)
    l_ = torch.zeros((b, h, nq, rq))
    for t in range(nk):
        kt = kp[:, :, None, t * rk:(t + 1) * rk]
        s = qt @ kt.transpose(-1, -2) * scale
        if plan.key_mask and t == nk - 1:
            s[..., lk - t * rk:] = -torch.inf
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_ = l_ * alpha + p.sum(dim=-1)
        vt = vp[:, :, None, t * rk:(t + 1) * rk]
        halves = vt.chunk(2, dim=-1) if plan.body == "wgmma_wide" else (vt,)
        o = o * alpha[..., None] + torch.cat([p.to(v.dtype).float() @ vh for vh in halves],
                                             dim=-1)
        m = m_new
    o = (o * (1.0 / l_)[..., None]).to(v.dtype).reshape(b, h, nq * rq, d)
    z = (m + torch.log(l_)).reshape(b, h, nq * rq)
    return o[:, :, :lq], z[:, :, :lq]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _close(o, z, o_p, z_p):
    assert float((o.float() - o_p.float()).abs().max()) <= FLASH_ATOL
    assert float((z - z_p).abs().max()) <= Z_ATOL


@pytest.mark.parametrize("b,h,lq,lk,d", [(2, 2, 200, 328, 64), (1, 2, 1, 300, 128),
                                         (1, 2, 77, 1, 64), (1, 3, 256, 256, 64),
                                         (2, 2, 200, 328, 256), (1, 1, 130, 77, 512),
                                         (1, 2, 64, 1, 512)])
def test_emulation_matches_the_head_major_plain_version(b, h, lq, lk, d):
    rng = np.random.default_rng(lq + lk)
    q, k, v = _bf16(rng, b, h, lq, d), _bf16(rng, b, h, lk, d), _bf16(rng, b, h, lk, d)
    o, z = emulate_fwd(q, k, v, d ** -0.5, _plan("head_major", b, h, lq, lk, d))
    _close(o, z, *fl.flash_attention_res_plain(q, k, v, d ** -0.5))


@pytest.mark.parametrize("layout,b,l,h,d", [("packed", 1, 1024, 12, 64), ("packed", 2, 192, 4, 64),
                                            ("packed", 2, 64, 2, 128),
                                            ("token_major", 1, 64, 2, 64),
                                            ("token_major", 2, 192, 1, 128),
                                            ("token_major", 2, 1024, 1, 512),
                                            ("token_major", 1, 192, 2, 256),
                                            ("packed", 1, 128, 2, 256)])
def test_emulation_matches_the_token_major_plain_versions(layout, b, l, h, d):
    rng = np.random.default_rng(l + h)
    c = h * d
    if layout == "packed":
        qkv = _bf16(rng, b, l, 3 * c)
        q, k, v = qkv.chunk(3, dim=-1)
        o_p, z_p = fa.flash_attention_qkv_res_plain(qkv, d ** -0.5, h)
    else:
        q, k, v = (_bf16(rng, b, l, c) for _ in range(3))
        o_p, z_p = fa.flash_attention_res_plain(q, k, v, d ** -0.5, h)
    hm = [t.reshape(b, l, h, d).transpose(1, 2) for t in (q, k, v)]
    o, z = emulate_fwd(*hm, d ** -0.5, _plan(layout, b, h, l, l, d))
    _close(o.transpose(1, 2).reshape(b, l, c), z, o_p, z_p)


def test_emulation_matches_the_jax_packed_kernel():
    """The packed training forward of the JAX package (``_fwd_impl``, its
    Pallas kernel in interpret mode) at (1, 256, 4, 64) bf16: o within
    2e-2 and z within 1e-3."""
    b, l, h, d = 1, 256, 4, 64
    rng = np.random.default_rng(21)
    qkv = rng.standard_normal((b, l, 3 * h * d)).astype(np.float32)
    jo, jz = _fwd_res_call_packed(jnp.asarray(qkv, jnp.bfloat16), d ** -0.5, h, True)
    hpb = _fwd_hpb(l, h, d, 2)  # z lanes: head within its group, 128 lanes a group
    lanes = [(hh // hpb) * 128 + hh % hpb for hh in range(h)]
    jz = torch.from_numpy(np.asarray(jz, np.float32)[..., lanes].transpose(0, 2, 1).copy())
    tq, tk, tv = (t.reshape(b, l, h, d).transpose(1, 2)
                  for t in torch.from_numpy(qkv).to(torch.bfloat16).chunk(3, dim=-1))
    o, z = emulate_fwd(tq, tk, tv, d ** -0.5, _plan("packed", b, h, l, l, d))
    _close(o.transpose(1, 2).reshape(b, l, h * d),
           z, torch.from_numpy(np.asarray(jo, np.float32)), jz)


def test_emulation_matches_the_jax_head_major_op():
    """The JAX head-major op in float32 (its Pallas kernels in TPU interpret
    mode, as the port's float32 tests run it) with a partial last q tile
    (the JAX op takes no key block off the 128 lanes, so the ragged keys are
    held to the plain versions above): the emulation's o within 1e-5 of its
    largest value (p stays float32 for float32 operands)."""
    b, h, lq, lk, d = 1, 2, 200, 384, 64
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    blocks = jfl.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1)
    with pltpu.force_tpu_interpret_mode():
        o_j = np.asarray(jfl.flash_attention(*map(jnp.asarray, (q, k, v)), d ** -0.5, blocks))
    o, _ = emulate_fwd(*map(torch.from_numpy, (q, k, v)), d ** -0.5,
                       _plan("head_major", b, h, lq, lk, d))
    assert float(np.abs(o.numpy() - o_j).max() / np.abs(o_j).max()) <= F32_REL


@pytest.mark.parametrize("b,l,h,d", [(2, 128, 2, 256), (1, 256, 1, 512)])
def test_wide_emulation_matches_the_jax_unpacked_kernels(b, l, h, d):
    """The unpacked forward of the JAX package in both forms, ``_fwd_impl``
    through ``_fwd_call`` (o) and ``_fwd_res_call`` (o, z), its Pallas
    kernel in interpret mode, at D = 256 and 512 bf16: o within 2e-2 and z
    within 1e-3 of the wide body's emulation, and the two JAX forms' o
    equal, as the kernel's two forms are."""
    rng = np.random.default_rng(l + d)
    q, k, v = (rng.standard_normal((b, l, h * d)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    jo = _fwd_call(jq, jk, jv, d ** -0.5, h, True)
    jo_res, jz = _fwd_res_call(jq, jk, jv, d ** -0.5, h, True)
    assert np.array_equal(np.asarray(jo, np.float32), np.asarray(jo_res, np.float32))
    hpb = _fwd_hpb(l, h, d, 2)  # z lanes: head within its group, 128 lanes a group
    lanes = [(hh // hpb) * 128 + hh % hpb for hh in range(h)]
    jz = torch.from_numpy(np.asarray(jz, np.float32)[..., lanes].transpose(0, 2, 1).copy())
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16).reshape(b, l, h, d).transpose(1, 2)
                  for t in (q, k, v))
    o, z = emulate_fwd(tq, tk, tv, d ** -0.5, _plan("token_major", b, h, l, l, d))
    _close(o.transpose(1, 2).reshape(b, l, h * d), z,
           torch.from_numpy(np.asarray(jo_res, np.float32)), jz)


def test_wide_emulation_matches_the_jax_head_major_op():
    """The JAX head-major op in float32 at D = 256 (TPU interpret mode) with
    ragged q tiles (200 rows: three 64-row tiles and 8 rows), as the D = 64
    test above: o within 1e-5 of its largest value."""
    b, h, lq, lk, d = 1, 1, 200, 384, 256
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    blocks = jfl.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1)
    with pltpu.force_tpu_interpret_mode():
        o_j = np.asarray(jfl.flash_attention(*map(jnp.asarray, (q, k, v)), d ** -0.5, blocks))
    o, _ = emulate_fwd(*map(torch.from_numpy, (q, k, v)), d ** -0.5,
                       _plan("head_major", b, h, lq, lk, d))
    assert float(np.abs(o.numpy() - o_j).max() / np.abs(o_j).max()) <= F32_REL
