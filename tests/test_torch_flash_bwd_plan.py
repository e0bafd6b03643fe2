"""The flash backward's launch planner (``ops/flash_attention.py``
``flash_bwd_plan``), the order of the wgmma bodies' arithmetic
(``csrc/flash_bwd_sm90.cuh`` at D = 64 and 128,
``csrc/flash_bwd_sm90_wide.cuh`` at D = 256 and 512) and the operand copy of
the public ops (``ops/_build.py`` ``kernel_operand``), on the CPU.

Both bodies read q, k, v and do through 4-D TMA maps.  At D = 64 and 128
the dK/dV kernel owns 128 keys and streams q tiles (64 rows at D = 64, 32 at
D = 128) on the transposed scores; the dQ kernel owns 128 q rows and
streams key tiles (128 at D = 64, 64 at D = 128).  At D = 256 and 512 a
block owns 64 keys (dK/dV) or 64 q rows (dQ) and 256 of the head dim's
columns (two blocks, a cluster, at D = 512), streams 32-row tiles, and its
two warpgroups each form the partial scores over their 128 columns, summed
across the warpgroups and then across the cluster.  Here:

- at the main-path shapes and at ragged ones, for each layout (head-major,
  token-major, packed at token stride 3C with do at stride C), a numpy
  emulation of TMA's box reads over the plan's maps (zero fill out of
  bounds) gives back exactly each (b, h)'s q, k, v and do, in both
  kernels' tiles, with zeros past L and nothing from a neighbouring head or
  sample (every element of the inputs carries its own id);
- the same shape gives the same plan, every plan fits the shared memory it
  states, and D = 256 and 512 get the wide body's plan;
- a plain emulation of both kernels' order (the plan's tiles, transposed
  score tiles in the dK/dV kernel, the wide body's partial scores over
  128-column quarters summed in pairs, p and ds rounded to the IO dtype,
  float32 sums in tile order, the masks past Lq and Lk) matches the port's
  plain backward within 2e-2 of max |grad| (the card's bar), and the JAX
  package's packed ``_bwd_call_packed`` and unpacked ``_bwd_call``
  (interpret mode) and head-major op's VJP (TPU interpret mode, float32);
- ``kernel_operand`` returns a tensor that a kernel can read as it is, and
  one aligned contiguous copy of any other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vqvae_from_gaussian_vae_tpu.ops import flash_attention as jfl
from vqvae_from_gaussian_vae_tpu.ops.flash_blc import (
    _bwd_call, _bwd_call_packed, _fwd_res_call, _fwd_res_call_packed)
from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl

BWD_REL = 2e-2     # max error over max |grad|: the JAX package's flash bar
F32_REL = 1e-5     # float32 operands: float32 sums in another order, over the largest value
SMEM_LIMIT = 232448  # a block's dynamic shared memory on an H100
SM_SHARED = 233472   # one SM's shared memory; the hardware keeps 1024 bytes a block

# (layout, B, H, Lq, Lk, D): the main-path shapes (the packed bsqvit
# attention, the head-major op's shapes), then ragged ones
MAIN = [("packed", 16, 12, 1024, 1024, 64), ("head_major", 1, 12, 8192, 8192, 64),
        ("head_major", 8, 12, 1024, 1024, 64), ("head_major", 2, 4, 512, 512, 64)]
RAGGED = ([("head_major", b, h, lq, lk, d) for b, h, lq, lk in
           [(1, 1, 1, 77), (2, 2, 77, 1), (2, 2, 200, 328), (1, 12, 328, 200)] for d in (64, 128)]
          + [("token_major", 1, 2, 64, 64, 64), ("token_major", 2, 12, 192, 192, 64),
             ("token_major", 2, 1, 64, 64, 128)]
          + [("packed", 1, 1, 64, 64, 64), ("packed", 2, 12, 192, 192, 64),
             ("packed", 2, 4, 64, 64, 128), ("packed", 1, 2, 328, 328, 64)])
# the wide body (D = 256 and 512): the UNet AttnBlock's shape, the head-major
# op's, then ragged ones (a single key, a single query row) in each layout
WIDE = [("token_major", 16, 1, 1024, 1024, 512), ("head_major", 2, 2, 200, 328, 256),
        ("packed", 2, 1, 64, 64, 256), ("head_major", 4, 2, 1024, 1024, 256),
        ("head_major", 2, 1, 1024, 1024, 512), ("packed", 1, 1, 128, 128, 512)]
WIDE_BOXES = [("token_major", 2, 1, 128, 128, 512), ("packed", 1, 1, 128, 128, 512),
              ("packed", 2, 2, 64, 64, 256), ("head_major", 2, 2, 200, 328, 256),
              ("head_major", 2, 2, 77, 1, 512), ("head_major", 1, 2, 1, 300, 256),
              ("token_major", 1, 1, 192, 192, 256), ("head_major", 1, 2, 45, 100, 512)]


def _stride(layout, h, d):
    return {"head_major": 0, "token_major": h * d, "packed": 3 * h * d}[layout]


def _plan(layout, b, h, lq, lk, d):
    return fa.flash_bwd_plan(layout, b, h, lq, lk, d, _stride(layout, h, d))


def _ids(layout, b, h, lq, lk, d):
    """(flat storage, {name: (B, H, L, D) view}) of q, k, v and do, every
    element's value its own id + 1 (so 0 is only ever the zero fill)."""
    c = h * d
    if layout == "head_major":
        sizes = {"q": (b, h, lq, d), "k": (b, h, lk, d), "v": (b, h, lk, d), "do": (b, h, lq, d)}
        flat, views, start = {}, {}, 1
        for name, shape in sizes.items():
            n = int(np.prod(shape))
            flat[name] = np.arange(start, start + n, dtype=np.int64)
            views[name] = flat[name].reshape(shape)
            start += n
        return flat, views
    tm = lambda t: t.reshape(b, lq, h, d).transpose(0, 2, 1, 3)  # noqa: E731
    n = b * lq * c
    if layout == "token_major":
        flat = {t: np.arange(1, n + 1, dtype=np.int64) + i * n
                for i, t in enumerate(("q", "k", "v", "do"))}
        return flat, {t: tm(flat[t]) for t in flat}
    qkv = np.arange(1, 3 * n + 1, dtype=np.int64).reshape(b, lq, 3 * c)
    flat = {t: qkv.reshape(-1) for t in "qkv"}
    flat["do"] = np.arange(1, n + 1, dtype=np.int64) + 3 * n
    views = {t: tm(qkv[..., i * c:(i + 1) * c]) for i, t in enumerate("qkv")}
    views["do"] = tm(flat["do"])
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


def _tiles(flat, plan, which, rows, b, h, length, d):
    """What a kernel's copies put in shared memory for every (b, h), tiles of
    `rows` rows, each made of `rows / box` boxes: (B, H, tiles * rows, D)."""
    m = plan.maps[which]
    box = m.box[plan.row_dim]
    assert rows % box == 0
    bb, hh = np.meshgrid(np.arange(b), np.arange(h), indexing="ij")
    out = []
    for t in range(-(-length // rows)):
        for r in range(0, rows, box):
            chunks = [_box(flat, m, plan.coords(c, t * rows + r, bb, hh))
                      .reshape(b, h, box, fa.SWIZZLE_COLS) for c in range(d // fa.SWIZZLE_COLS)]
            out.append(np.concatenate(chunks, axis=-1))
    return np.concatenate(out, axis=2)


@pytest.mark.parametrize("layout,b,h,lq,lk,d", MAIN + RAGGED + WIDE_BOXES)
def test_plan_boxes_read_each_head_exactly(layout, b, h, lq, lk, d):
    plan = _plan(layout, b, h, lq, lk, d)
    assert plan.body == ("wgmma" if d in fa.WGMMA_HEAD_DIMS else "wgmma_wide")
    assert plan.row_dim == (1 if layout == "head_major" else 2)
    flat, views = _ids(layout, b, h, lq, lk, d)
    # the dK/dV kernel: a block of keys of k and v, q and do in q tiles; the
    # dQ kernel: a block of q rows of q and do, k and v in key tiles (at
    # D = 512 each block of a cluster reads its half of the chunks, which
    # together are these reads)
    reads = [(0, "q", lq, plan.kv_q_rows), (3, "do", lq, plan.kv_q_rows),
             (1, "k", lk, plan.kv_rows), (2, "v", lk, plan.kv_rows),
             (0, "q", lq, plan.q_rows), (3, "do", lq, plan.q_rows),
             (1, "k", lk, plan.q_k_rows), (2, "v", lk, plan.q_k_rows)]
    for which, name, length, rows in dict.fromkeys(reads):  # each distinct read once
        got = _tiles(flat[name], plan, which, rows, b, h, length, d)
        want = np.zeros_like(got)
        want[:, :, :length] = views[name]
        assert np.array_equal(got, want), (name, rows)


@pytest.mark.parametrize("layout,b,h,lq,lk,d", MAIN + RAGGED + WIDE)
def test_plans_repeat_and_fit(layout, b, h, lq, lk, d):
    plan = _plan(layout, b, h, lq, lk, d)
    assert plan == fa.flash_bwd_plan.__wrapped__(layout, b, h, lq, lk, d, _stride(layout, h, d))
    assert list(plan.as_array()) == list(_plan(layout, b, h, lq, lk, d).as_array())
    for smem in (plan.kv_smem, plan.q_smem):
        assert smem <= SMEM_LIMIT and smem + 1024 <= SM_SHARED
    assert plan.kv_grid == (-(-lk // plan.kv_rows), b * h)
    assert plan.q_grid == (-(-lq // plan.q_rows), b * h)
    assert plan.q_mask == (lq % plan.kv_q_rows != 0) and plan.key_mask == (lk % plan.q_k_rows != 0)
    out = 3 * h * d if layout == "packed" else h * d
    if layout == "head_major":
        assert plan.dq_strides == (h * lq * d, lq * d, d)
        assert plan.dkv_strides == (h * lk * d, lk * d, d)
    else:
        assert plan.dq_strides == plan.dkv_strides == (lq * out, d, out)
    if d in fa.WGMMA_HEAD_DIMS:
        nq, nk = fa.BWD_Q_TILE[d], fa.BWD_K_TILE[d]
        assert plan.body == "wgmma" and plan.splits == 1
        assert (plan.kv_rows, plan.kv_q_rows, plan.q_rows, plan.q_k_rows, plan.stages,
                plan.threads) == (128, nq, 128, nk, 3, 384)
        assert plan.kv_smem == (256 + 6 * nq) * d * 2 + 6 * nq * 4 + 80 + 1024
        assert plan.q_smem == (256 + 6 * nk) * d * 2 + 56 + 1024
    else:
        nq = nk = 32
        assert plan.body == "wgmma_wide" and plan.splits == d // 256
        assert (plan.kv_rows, plan.kv_q_rows, plan.q_rows, plan.q_k_rows, plan.stages,
                plan.threads) == (64, nq, 64, nk, 3, 384)
        # the block's 256 columns of two 64-row tiles and three stages of two
        # 32-row tiles, the exchange tile, two cluster tiles at D = 512, z
        # and di (dK/dV), the mbarriers, the alignment slack
        cross = 2 * 16384 if d == 512 else 0
        assert plan.kv_smem == (128 + 192) * 512 + 32768 + cross + 768 + 12 * 8 + 1024
        assert plan.q_smem == (128 + 192) * 512 + 32768 + cross + 9 * 8 + 1024
        assert (plan.kv_smem, plan.q_smem) == fa.wide_bwd_smem(d)
    assert [m.box[plan.row_dim] for m in plan.maps] == [nq, nk, nk, nq]
    for m in plan.maps:  # TMA: 16-byte strides and bases, boxes of <= 256, 128 bytes wide
        assert all(s % 16 == 0 for s in m.strides) and (2 * m.offset) % 16 == 0
        assert max(m.box) <= 256 and m.box[0] * 2 == 128
    arr = list(plan.as_array())
    assert len(arr) == 71 and arr[0] == 1 + fa.BWD_BODIES.index(plan.body)
    assert arr[6:10] == [*plan.kv_grid, *plan.q_grid] and arr[-1] == plan.splits


def test_plan_refuses_what_no_body_takes():
    for args in [("head_major", 1, 1, 128, 128, 96), ("token_major", 1, 1, 128, 64, 64, 64),
                 ("packed", 1, 1, 128, 128, 64, 32), ("blc", 1, 1, 128, 128, 64),
                 ("head_major", 1, 1, 0, 128, 64)]:
        with pytest.raises(ValueError):
            fa.flash_bwd_plan(*args)


def _pad(t, n):
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))


def _scores(a, b, plan):
    """a b^T in float32 as the plan's body sums it: the wgmma body over the
    whole head dim in one product; the wide body over 128-column quarters
    (one a warpgroup), summed in pairs (a block's two warpgroups), then the
    pairs (a cluster's two blocks at D = 512)."""
    if plan.body != "wgmma_wide":
        return a @ b.transpose(-1, -2)
    parts = [a[..., c:c + 128] @ b[..., c:c + 128].transpose(-1, -2)
             for c in range(0, a.shape[-1], 128)]
    pairs = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return pairs[0] if len(pairs) == 1 else pairs[0] + pairs[1]


def emulate_bwd(q, k, v, o, z, do, scale, plan):
    """Both kernels' order on (B, H, Lq, D) q, o, do and (B, H, Lk, D) k, v,
    z (B, H, Lq) float32: (dq, dk, dv) in q's dtype.

    dK/dV: per block of plan.kv_rows keys, per q tile of plan.kv_q_rows rows
    (zero-filled past Lq), the transposed scores S^T = K Q^T and
    dP^T = V dO^T in float32 (``_scores``), p = exp(S^T scale - z) and
    ds = p (dP^T - di) scale with z and di by column (0 past Lq) and both 0
    in the columns past Lq, then dV += round(p) dO and dK += round(ds) Q in
    float32, tile after tile.  dQ: per block of plan.q_rows q rows, per key
    tile of plan.q_k_rows keys, S and dP, ds with z and di by row and 0 in
    the key columns past Lk, dQ += round(ds) K.  di = rowsum(do * o) in
    float32 (the pre-pass).  The wide body's split of the output columns
    over warpgroups and blocks leaves each column's sums as they are."""
    io = q.dtype
    b, h, lq, d = q.shape
    lk = k.shape[2]
    f = lambda t: t.float()  # noqa: E731
    di = (f(do) * f(o)).sum(-1)
    nq, nk, rows = plan.kv_q_rows, plan.q_k_rows, plan.kv_rows
    up = lambda n, t: -(-n // t) * t  # noqa: E731
    lq_p, lk_p = max(up(lq, nq), up(lq, rows)), max(up(lk, nk), up(lk, rows))
    qp, dop = _pad(f(q), lq_p), _pad(f(do), lq_p)
    kp, vp = _pad(f(k), lk_p), _pad(f(v), lk_p)
    zp = torch.nn.functional.pad(z, (0, qp.shape[2] - lq))
    dip = torch.nn.functional.pad(di, (0, qp.shape[2] - lq))
    dks, dvs = [], []
    for k0 in range(0, lk, rows):
        kb, vb = kp[:, :, k0:k0 + rows], vp[:, :, k0:k0 + rows]
        dk = torch.zeros((b, h, rows, d))
        dv = torch.zeros((b, h, rows, d))
        for q0 in range(0, lq, nq):
            qt, dot = qp[:, :, q0:q0 + nq], dop[:, :, q0:q0 + nq]
            st = _scores(kb, qt, plan)                          # keys x q rows
            dpt = _scores(vb, dot, plan)
            p = torch.exp(st * scale - zp[:, :, None, q0:q0 + nq])
            ds = p * (dpt - dip[:, :, None, q0:q0 + nq]) * scale
            cols = torch.arange(q0, q0 + nq) >= lq
            p, ds = p.masked_fill(cols, 0.0), ds.masked_fill(cols, 0.0)
            dv = dv + p.to(io).float() @ dot
            dk = dk + ds.to(io).float() @ qt
        dks.append(dk)
        dvs.append(dv)
    dqs = []
    for q0 in range(0, lq, rows):
        qb, dob = qp[:, :, q0:q0 + rows], dop[:, :, q0:q0 + rows]
        zb, dib = zp[:, :, q0:q0 + rows, None], dip[:, :, q0:q0 + rows, None]
        dq = torch.zeros((b, h, rows, d))
        for t0 in range(0, lk, nk):
            kt, vt = kp[:, :, t0:t0 + nk], vp[:, :, t0:t0 + nk]
            s = _scores(qb, kt, plan)
            dp = _scores(dob, vt, plan)
            ds = torch.exp(s * scale - zb) * (dp - dib) * scale
            ds = ds.masked_fill(torch.arange(t0, t0 + nk) >= lk, 0.0)
            dq = dq + ds.to(io).float() @ kt
        dqs.append(dq)
    cat = lambda ts, n: torch.cat(ts, dim=2)[:, :, :n].to(io)  # noqa: E731
    return cat(dqs, lq), cat(dks, lk), cat(dvs, lk)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,h,lq,lk,d", [(2, 2, 200, 328, 64), (1, 2, 200, 328, 128),
                                         (1, 2, 1, 300, 128), (1, 3, 256, 256, 64),
                                         (1, 2, 77, 130, 64), (2, 2, 200, 328, 256),
                                         (2, 2, 200, 328, 512), (2, 2, 77, 1, 256),
                                         (2, 2, 77, 1, 512), (1, 2, 1, 300, 256),
                                         (1, 2, 1, 300, 512)])
def test_emulation_matches_the_head_major_plain_version(b, h, lq, lk, d):
    rng = np.random.default_rng(lq + lk + d)
    q, k, v, do = (_bf16(rng, b, h, n, d) for n in (lq, lk, lk, lq))
    scale = d ** -0.5
    o, z = fl.flash_attention_res_plain(q, k, v, scale)
    got = emulate_bwd(q, k, v, o, z, do, scale, _plan("head_major", b, h, lq, lk, d))
    want = fl.flash_attention_bwd_plain(q, k, v, o, z, do, scale)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        if lk == 1 and i < 2:
            # one key: p = 1 and ds = 0 in exact arithmetic, so dq and dk are
            # rounding noise with no relative error; hold them to dv's scale
            assert float(g.float().abs().max()) <= 1e-4 * float(want[2].float().abs().max())
        else:
            assert _rel(g.float(), w.float()) <= BWD_REL


@pytest.mark.parametrize("layout,b,l,h,d", [("packed", 1, 1024, 12, 64), ("packed", 2, 192, 4, 64),
                                            ("packed", 2, 64, 2, 128),
                                            ("token_major", 1, 64, 2, 64),
                                            ("token_major", 2, 192, 1, 128),
                                            ("token_major", 2, 128, 1, 512),
                                            ("packed", 1, 128, 1, 512),
                                            ("packed", 2, 64, 2, 256)])
def test_emulation_matches_the_token_major_plain_versions(layout, b, l, h, d):
    rng = np.random.default_rng(l + h)
    c, scale = h * d, d ** -0.5
    do = _bf16(rng, b, l, c)
    if layout == "packed":
        qkv = _bf16(rng, b, l, 3 * c)
        q, k, v = qkv.chunk(3, dim=-1)
        o, z = fa.flash_attention_qkv_res_plain(qkv, scale, h)
        want = fa.flash_attention_qkv_bwd_plain(qkv, o, z, do, scale, h).chunk(3, dim=-1)
    else:
        q, k, v = (_bf16(rng, b, l, c) for _ in range(3))
        o, z = fa.flash_attention_res_plain(q, k, v, scale, h)
        want = fa.flash_attention_bwd_plain(q, k, v, o, z, do, scale, h)
    hm = lambda t: t.reshape(b, l, h, d).transpose(1, 2)  # noqa: E731
    got = emulate_bwd(*map(hm, (q, k, v, o)), z, hm(do), scale, _plan(layout, b, h, l, l, d))
    for g, w in zip(got, want):
        assert _rel(g.transpose(1, 2).reshape(b, l, c).float(), w.float()) <= BWD_REL


def test_emulation_matches_the_jax_packed_kernel():
    """The packed backward of the JAX package (``_bwd_call_packed`` after
    ``_fwd_res_call_packed``, its Pallas kernels in interpret mode) at (1,
    256, 4, 64) bf16 against the emulation on the port's plain forward:
    each of dq, dk, dv within 2e-2 of its max |grad|."""
    b, l, h, d = 1, 256, 4, 64
    rng = np.random.default_rng(21)
    qkv = rng.standard_normal((b, l, 3 * h * d)).astype(np.float32)
    do = rng.standard_normal((b, l, h * d)).astype(np.float32)
    scale = d ** -0.5
    jqkv, jdo = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(do, jnp.bfloat16)
    jo, jz = _fwd_res_call_packed(jqkv, scale, h, True)
    want = _bwd_call_packed(jqkv, jo, jz, jdo, scale, h, True)
    tqkv, tdo = torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(do).to(torch.bfloat16)
    o, z = fa.flash_attention_qkv_res_plain(tqkv, scale, h)
    hm = lambda t: t.reshape(b, l, h, d).transpose(1, 2)  # noqa: E731
    got = emulate_bwd(*map(hm, (*tqkv.chunk(3, dim=-1), o)), z, hm(tdo), scale,
                      _plan("packed", b, h, l, l, d))
    for g, w in zip(got, want):
        assert _rel(g.transpose(1, 2).reshape(b, l, h * d).float(), np.asarray(w, np.float32)) \
            <= BWD_REL


def test_emulation_matches_the_jax_unpacked_kernel():
    """The unpacked backward of the JAX package (``_bwd_call`` after
    ``_fwd_res_call``, its Pallas kernels in interpret mode) at the UNet
    AttnBlock's head dim, (1, 128, 1 x 512) bf16, against the wide body's
    emulation on the port's plain forward: each of dq, dk, dv within 2e-2 of
    its max |grad|."""
    b, l, h, d = 1, 128, 1, 512
    rng = np.random.default_rng(22)
    q, k, v, do = (rng.standard_normal((b, l, h * d)).astype(np.float32) for _ in range(4))
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do))
    jo, jz = _fwd_res_call(jq, jk, jv, scale, h, True)
    want = _bwd_call(jq, jk, jv, jo, jz, jdo, scale, h, True)
    tq, tk, tv, tdo = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v, do))
    o, z = fa.flash_attention_res_plain(tq, tk, tv, scale, h)
    hm = lambda t: t.reshape(b, l, h, d).transpose(1, 2)  # noqa: E731
    plan = _plan("token_major", b, h, l, l, d)
    assert plan.body == "wgmma_wide" and plan.splits == 2
    got = emulate_bwd(*map(hm, (tq, tk, tv, o)), z, hm(tdo), scale, plan)
    for g, w in zip(got, want):
        assert _rel(g.transpose(1, 2).reshape(b, l, h * d).float(), np.asarray(w, np.float32)) \
            <= BWD_REL


def test_emulation_matches_the_jax_head_major_op_at_d256():
    """The JAX head-major op's VJP in float32 at D = 256 (its Pallas kernels
    in TPU interpret mode) with a partial last q tile and q block, against
    the wide body's emulation: dq, dk, dv within 1e-5 of their largest
    value."""
    b, h, lq, lk, d = 1, 1, 200, 384, 256
    rng = np.random.default_rng(6)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d), (b, h, lq, d)))
    scale = d ** -0.5
    blocks = jfl.BlockSizes(block_q=200, block_k_major=128, block_k=128, block_b=1,
                            block_q_major_dkv=200, block_k_major_dkv=128, block_k_dkv=128,
                            block_q_dkv=200, block_k_major_dq=128, block_k_dq=128,
                            block_q_dq=200)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b_, c: jfl.flash_attention(a, b_, c, scale, blocks),
                         *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, z = fl.flash_attention_res_plain(tq, tk, tv, scale)
    plan = _plan("head_major", b, h, lq, lk, d)
    assert plan.body == "wgmma_wide" and plan.q_mask and not plan.key_mask
    got = emulate_bwd(tq, tk, tv, o, z, tdo, scale, plan)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= F32_REL


def test_emulation_matches_the_jax_head_major_op():
    """The JAX head-major op's VJP in float32 (its Pallas kernels in TPU
    interpret mode, as the port's float32 tests run it) with a partial last
    q tile of the dK/dV kernel and of the dQ kernel's block: dq, dk, dv
    within 1e-5 of their largest value (p and ds stay float32 for float32
    operands)."""
    b, h, lq, lk, d = 1, 2, 200, 384, 64
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d), (b, h, lq, d)))
    scale = d ** -0.5
    blocks = jfl.BlockSizes(block_q=200, block_k_major=128, block_k=128, block_b=1,
                            block_q_major_dkv=200, block_k_major_dkv=128, block_k_dkv=128,
                            block_q_dkv=200, block_k_major_dq=128, block_k_dq=128,
                            block_q_dq=200)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b_, c: jfl.flash_attention(a, b_, c, scale, blocks),
                         *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, z = fl.flash_attention_res_plain(tq, tk, tv, scale)
    got = emulate_bwd(tq, tk, tv, o, z, tdo, scale, _plan("head_major", b, h, lq, lk, d))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= F32_REL


def test_kernel_operand_copies_only_what_a_kernel_cannot_read():
    """A 16-byte-aligned contiguous tensor comes back as itself; a view
    whose data starts 2 bytes past a boundary, and a transposed view, come
    back as one contiguous copy on 16 bytes with equal values."""
    base = torch.arange(1 + 4 * 6 * 8, dtype=torch.float32).to(torch.bfloat16)
    fresh = base[:-1].clone().view(4, 6, 8)
    assert fresh.data_ptr() % 16 == 0 and _build.kernel_operand(fresh) is fresh
    misaligned = base[1:].view(4, 6, 8)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 2
    transposed = fresh.transpose(1, 2)
    assert not transposed.is_contiguous()
    for t in (misaligned, transposed):
        got = _build.kernel_operand(t)
        assert got is not t and got.data_ptr() != t.data_ptr()
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert got.shape == t.shape and got.dtype == t.dtype and torch.equal(got, t)
