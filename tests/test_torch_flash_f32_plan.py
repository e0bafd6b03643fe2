"""The float32 head-major flash bodies' launch plan and arithmetic
(``ops/flash_attention.py:flash_f32_plan``; ``csrc/flash_f32_sm90.cuh``,
``csrc/flash_fwd_f32_sm90.cuh``, ``csrc/flash_bwd_f32_sm90.cuh`` and their
wide form at D = 256 and 512, ``csrc/flash_fwd_f32_sm90_wide.cuh``,
``csrc/flash_bwd_f32_sm90_wide.cuh``), on the CPU.

The plan: tiles and stages that fit a block's shared memory (at D = 256 and
512 with the exchange of partial scores, for every compiled tiling),
clusters of D / share blocks, every product's B operand K-major (a map
whose inner dimension is the product's contraction, as ``wgmma`` takes
.tf32 operands with no transpose), grids and boxes at ragged lengths.  The
arithmetic: a torch model of what the kernels compute (key and q tiles of
the plan, at D = 256 and 512 the partial scores over each block's columns
summed in rank order, the online softmax, the round-to-nearest TF32 split,
three passes with the small terms first, float32 sums) held to the JAX op
in float32, its Pallas kernels in TPU interpret mode, within 1e-4 of the
largest value; and one pass shown to miss that bar, so that no change
drops passes unnoticed.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vqvae_from_gaussian_vae_tpu.ops import flash_attention as jfl
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl

REL = 1e-4  # the float32 kernels' bar on the card: max error over max |value|
SMEM_LIMIT = 232448  # a block's dynamic shared memory on an H100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, H, Lq, Lk, D): D = 64, and a ragged Lq != Lk at D = 128 (Lq = 200
# leaves partial q tiles in every kernel); the wide bodies at a ragged Lq
# != Lk (partial 64-row q tiles, and at Lq = 77 partial 8-row ones; the JAX
# op's dK/dV kernel takes key blocks of 128 lanes only, so Lk is whole)
SHAPES = [(1, 2, 256, 256, 64), (1, 1, 200, 384, 128)]
WIDE_SHAPES = [(1, 1, 200, 384, 256), (1, 1, 77, 256, 512)]
ALL_DIMS = fa.F32_HEAD_DIMS + fa.F32_WIDE_HEAD_DIMS
# the wide kernels' shared memory at their tilings (bytes): TwFwdLayout,
# TwKvLayout and TwQLayout summed by hand from their parts
WIDE_SMEM = {256: {"fwd": 214088, "dkdv": 214496, "dq": 214088},
             512: {"fwd": 189536, "dkdv": 222408, "dq": 230472}}


# ---------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("d", fa.F32_HEAD_DIMS)
def test_plan_tiles_fit_and_name_the_split_tf32_body(d):
    plan = fa.flash_f32_plan(2, 3, 1000, 777, d)
    assert plan.body == "split_tf32"
    for name, kernel in (("fwd", plan.fwd), ("dkdv", plan.dkdv), ("dq", plan.dq)):
        assert kernel.smem == fa.f32_smem(name, d) <= SMEM_LIMIT
        assert kernel.rows % 64 == 0 and kernel.threads == 128 * (kernel.rows // 64 + 1)
        assert kernel.stages >= 2 and kernel.tile % 8 == 0
    assert plan.fwd_scratch == 2 * 6 * (1000 * d + 777 * d + d * 784)
    assert plan.bwd_scratch == 2 * 6 * d * (2 * 1000 + 2 * 777 + 1000 + 784 + 1000)
    assert len(plan.as_array()) == 203


# each product: (map of its B operand, contraction length, N of the product:
# the share of D's columns where N is D)
def _products(plan, d):
    f, kv, q = plan.fwd, plan.dkdv, plan.dq
    return [("fwd_k", d, f.tile), ("fwd_vt", plan.lk_pitch, f.share),        # S, O
            ("dkdv_q", d, kv.tile), ("dkdv_do", d, kv.tile),                  # S^T, dP^T
            ("dkdv_dot", plan.lq_pitch, kv.share), ("dkdv_qt", plan.lq_pitch, kv.share),  # dV, dK
            ("dq_k", d, q.tile), ("dq_v", d, q.tile), ("dq_kt", plan.lk_pitch, q.share)]  # S, dP, dQ


@pytest.mark.parametrize("d", ALL_DIMS)
@pytest.mark.parametrize("lq,lk", [(512, 512), (200, 328), (1, 300), (77, 1)])
def test_every_b_operand_is_k_major(d, lq, lk):
    """A B operand's map has the product's contraction as its inner
    dimension (K-major), a box of at most 128 bytes along it, and the
    product's N (keys, q rows, or the block's share of D) as its box rows;
    the A operands held in shared memory (q, k, v, do "rows" planes) are
    K-major in D, a box 32 columns wide."""
    b, h = 2, 3
    plan = fa.flash_f32_plan(b, h, lq, lk, d)
    for name, contraction, n in _products(plan, d):
        m = plan.maps[name]
        assert m.dims[0] == contraction and m.dims[2:] == (2, b * h)
        assert m.box[0] * 4 in (32, 64, 128) and m.box[1] == n and m.box[2:] == (1, 1)
        assert m.strides == (4 * m.dims[0], 4 * m.dims[0] * m.dims[1],
                             8 * m.dims[0] * m.dims[1])
    for name, n, rows in (("fwd_q", lq, plan.fwd.rows), ("dkdv_k", lk, plan.dkdv.rows),
                          ("dkdv_v", lk, plan.dkdv.rows), ("dq_q", lq, plan.dq.rows),
                          ("dq_do", lq, plan.dq.rows)):
        m = plan.maps[name]
        assert m.dims == (d, n, 2, b * h) and m.box == (32, rows, 1, 1)
    # the dK/dV and dQ kernels read one set of "rows" planes
    for t in ("q", "k", "v", "do"):
        assert plan.maps["dkdv_" + t].offset == plan.maps["dq_" + t].offset
        assert plan.maps["dkdv_" + t].dims == plan.maps["dq_" + t].dims


@pytest.mark.parametrize("d", ALL_DIMS)
def test_ragged_lengths_give_the_grids_masks_and_pitches(d):
    b, h, lq, lk = 2, 3, 200, 328
    plan = fa.flash_f32_plan(b, h, lq, lk, d)
    assert (plan.lq_pitch, plan.lk_pitch) == (200, 328)
    assert plan.fwd.grid == (-(-lq // plan.fwd.rows), b * h)
    assert plan.dkdv.grid == (-(-lk // plan.dkdv.rows), b * h)
    assert plan.dq.grid == (-(-lq // plan.dq.rows), b * h)
    assert plan.fwd.mask == (lk % plan.fwd.tile != 0)
    assert plan.dkdv.mask == (lq % plan.dkdv.tile != 0)
    assert plan.dq.mask == (lk % plan.dq.tile != 0)
    odd = fa.flash_f32_plan(1, 1, 77, 301, d)
    assert (odd.lq_pitch, odd.lk_pitch) == (80, 304)
    assert odd.maps["fwd_vt"].dims[0] == 304 and odd.maps["dkdv_qt"].dims[0] == 80
    assert odd.dkdv.mask and odd.dq.mask and odd.fwd.mask
    # the planes tile the scratch with no overlap, 16-byte aligned
    for names, total in ((fa.F32_MAPS[:3], odd.fwd_scratch),
                         (("dkdv_q", "dkdv_k", "dkdv_v", "dkdv_do", "dkdv_qt", "dq_kt",
                           "dkdv_dot"), odd.bwd_scratch)):
        at = 0
        for name in names:
            m = odd.maps[name]
            assert m.offset == at and m.offset % 4 == 0
            at += int(np.prod(m.dims))
        assert at == total


@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
def test_wide_head_dims_name_the_wide_body_and_fit(d):
    """At D = 256 and 512 the plan names the wide split-TF32 body: a block
    one consumer warpgroup of 64 rows and a producer warpgroup, a share of
    D's columns, D / share blocks (at most 8) a cluster; each kernel's
    shared memory, the exchange of partial scores included, within a
    block's; the same scratch as the D = 64 and 128 bodies; 203 numbers,
    each kernel's tiles in their place."""
    plan = fa.flash_f32_plan(2, 3, 1000, 777, d)
    assert plan.body == "split_tf32_wide"
    arr = list(plan.as_array())
    assert len(arr) == 203 and arr[0] == 1
    for i, (name, kernel) in enumerate((("fwd", plan.fwd), ("dkdv", plan.dkdv),
                                        ("dq", plan.dq))):
        assert (kernel.share, kernel.tile, kernel.stages) == fa.F32_WIDE_TILES[name][d]
        assert kernel.rows == 64 and kernel.threads == 256
        assert kernel.cluster == d // kernel.share <= 8 and d % kernel.share == 0
        assert kernel.smem == fa.f32_smem(name, d) == WIDE_SMEM[d][name] <= SMEM_LIMIT
        assert arr[1 + 10 * i:11 + 10 * i] == kernel.as_list()
    assert plan.fwd_scratch == 2 * 6 * (1000 * d + 777 * d + d * 784)
    assert plan.bwd_scratch == 2 * 6 * d * (2 * 1000 + 2 * 777 + 1000 + 784 + 1000)


def _wide_smem(kernel, d, share, tile, stages):
    """A wide kernel's shared memory from its C layout's parts: the block's
    64-row resident share (Q; K and V; Q and dO: 8 bytes an element, two
    planes), the ring's stages, the exchange (two buffers of a slot for
    each other block: the tile's partial scores of 128 threads, S in the
    forward, S and dP in the backward), the dK/dV kernel's z and di, the
    mbarriers and 1024 bytes of alignment slack."""
    others = d // share - 1
    if kernel == "fwd":
        parts = (8 * 64 * share, stages * 16 * tile * share, 2 * others * (tile // 2) * 4 * 128,
                 (3 + 3 * stages) * 8)
    elif kernel == "dkdv":
        parts = (2 * 8 * 64 * share, stages * 4 * 8 * tile * share, 2 * others * tile * 4 * 128,
                 stages * 2 * tile * 4, (3 + 3 * stages) * 8)
    else:
        parts = (2 * 8 * 64 * share, stages * 3 * 8 * tile * share, 2 * others * tile * 4 * 128,
                 (3 + 2 * stages) * 8)
    return sum(parts) + 1024


def _c_wide_tiles():
    """csrc/flash_f32_sm90.cuh's TwTiles table: {D: {kernel: (share, tile,
    stages)}}, the tilings the C entries compile."""
    path = os.path.join(ROOT, "vqvae_from_gaussian_vae_tpu_torch", "csrc", "flash_f32_sm90.cuh")
    with open(path) as f:
        src = f.read()
    table = {}
    for d, body in re.findall(r"struct TwTiles<(\d+)> \{(.*?)\n\};", src, re.S):
        table[int(d)] = {name.lower(): tuple(int(x) for x in vals.split(","))
                         for name, vals in re.findall(r"k(Fwd|Dkdv|Dq)\[3\] = \{([^}]*)\}", body)}
    return table


@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
@pytest.mark.parametrize("kernel", fa.F32_KERNELS)
def test_wide_tiles_fit_and_are_the_tilings_the_c_entries_compile(d, kernel):
    """Each wide kernel's tiling in the plan is the one TwTiles gives the C
    entry (the only one it compiles), and fits a block with its exchange
    (two buffers, a slot of the tile's partial scores for each other block
    of the cluster)."""
    share, tile, stages = fa.F32_WIDE_TILES[kernel][d]
    assert _c_wide_tiles()[d][kernel] == (share, tile, stages)
    t = getattr(fa.flash_f32_plan(1, 2, 300, 200, d), kernel)
    assert (t.share, t.tile, t.stages, t.cluster) == (share, tile, stages, d // share)
    assert 2 <= t.cluster <= 8 and tile % 8 == 0 and stages >= 2
    assert t.smem == _wide_smem(kernel, d, share, tile, stages) <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# the arithmetic


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
    (``cvt.rna.tf32.f32``), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm(a, b, passes=3):
    """a @ b as the kernels' wgmma passes: float32 sums of exact TF32
    products, lo.hi, then hi.lo, then hi.hi (one pass: hi.hi)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if passes == 1:
        return ah @ bh
    return ((al @ bh) + (ah @ bl)) + ah @ bh


def model_fwd(q, k, v, scale, nk, passes=3):
    """The forward body: an online softmax over nk-key tiles, (o, z)."""
    lk = k.shape[2]
    m = torch.full(q.shape[:3], -torch.inf)
    l, o = torch.zeros(q.shape[:3]), torch.zeros(q.shape)
    for k0 in range(0, lk, nk):
        kt, vt = k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk]
        s = mm(q, kt.transpose(-1, -2), passes) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vt, passes)
        m = m_new
    return o / l[..., None], m + torch.log(l)


def model_bwd(q, k, v, o, z, do, scale, nq, nk, passes=3):
    """The backward bodies: dK/dV over nq-row q tiles, dQ over nk-key tiles."""
    di = (o * do).sum(-1)

    def probs(qs, ks, vs, dos, zs, dis):
        p = torch.exp(mm(qs, ks.transpose(-1, -2), passes) * scale - zs[..., None])
        return p, p * (mm(dos, vs.transpose(-1, -2), passes) - dis[..., None]) * scale

    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, q.shape[2], nq):
        sl = slice(q0, q0 + nq)
        p, ds = probs(q[:, :, sl], k, v, do[:, :, sl], z[:, :, sl], di[:, :, sl])
        dv = dv + mm(p.transpose(-1, -2), do[:, :, sl], passes)
        dk = dk + mm(ds.transpose(-1, -2), q[:, :, sl], passes)
    dq = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], nk):
        sl = slice(k0, k0 + nk)
        _, ds = probs(q, k[:, :, sl], v[:, :, sl], do, z, di)
        dq = dq + mm(ds, k[:, :, sl], passes)
    return dq, dk, dv


def shared_mm(a, b, share, passes=3):
    """a @ b^T over the last dim of both as the wide bodies form it: each
    block of the cluster its partial over its `share` columns (three TF32
    passes), the partials summed in rank order (((p0 + p1) + p2) + ...)."""
    parts = [mm(a[..., c:c + share], b[..., c:c + share].transpose(-1, -2), passes)
             for c in range(0, a.shape[-1], share)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def by_share(p, x, share, passes=3):
    """p @ x as the wide bodies accumulate it: each block its own columns."""
    return torch.cat([mm(p, x[..., c:c + share], passes)
                      for c in range(0, x.shape[-1], share)], dim=-1)


def model_fwd_wide(q, k, v, scale, nk, share):
    """The wide forward body: per nk-key tile the partial scores summed over
    the cluster, the online softmax on the sum (the same bits in every
    block), P V over each block's columns; (o, z)."""
    lk = k.shape[2]
    m = torch.full(q.shape[:3], -torch.inf)
    l, o = torch.zeros(q.shape[:3]), torch.zeros(q.shape)
    for k0 in range(0, lk, nk):
        kt, vt = k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk]
        s = shared_mm(q, kt, share) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + by_share(p, vt, share)
        m = m_new
    return o / l[..., None], m + torch.log(l)


def model_bwd_wide(q, k, v, o, z, do, scale, kv_tiles, q_tiles):
    """The wide backward bodies: dK/dV over (share, nq) q tiles, dQ over
    (share, nk) key tiles, each tile's S and dP summed over the cluster's
    partials, each block accumulating its own columns."""
    di = (o * do).sum(-1)
    (kv_share, nq), (q_share, nk) = kv_tiles, q_tiles

    def probs(qs, ks, vs, dos, zs, dis, share):
        p = torch.exp(shared_mm(qs, ks, share) * scale - zs[..., None])
        return p, p * (shared_mm(dos, vs, share) - dis[..., None]) * scale

    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, q.shape[2], nq):
        sl = slice(q0, q0 + nq)
        p, ds = probs(q[:, :, sl], k, v, do[:, :, sl], z[:, :, sl], di[:, :, sl], kv_share)
        dv = dv + by_share(p.transpose(-1, -2), do[:, :, sl], kv_share)
        dk = dk + by_share(ds.transpose(-1, -2), q[:, :, sl], kv_share)
    dq = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], nk):
        sl = slice(k0, k0 + nk)
        _, ds = probs(q, k[:, :, sl], v[:, :, sl], do, z, di, q_share)
        dq = dq + by_share(ds, k[:, :, sl], q_share)
    return dq, dk, dv


def _inputs(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d), (b, h, lq, d))]


def _blocks(cls, lq, lk):
    bq, bk = min(lq, 256), lk if lk % 512 else 512
    return cls(block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
               block_q_major_dkv=lq, block_k_major_dkv=bk, block_k_dkv=bk, block_q_dkv=lq,
               block_k_major_dq=bk, block_k_dq=bk, block_q_dq=lq)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_op(shape):
    """Inputs and the JAX op's float32 o, z, dq, dk, dv (interpret mode)."""
    b, h, lq, lk, d = shape
    arrays = _inputs(b, h, lq, lk, d, seed=lq + d)
    q, k, v, do = map(jnp.asarray, arrays)
    scale, blocks = d ** -0.5, _blocks(jfl.BlockSizes, lq, lk)
    with pltpu.force_tpu_interpret_mode():
        o, (*_, l, m) = jfl._fwd(q, k, v, scale, blocks)
        _, vjp = jax.vjp(lambda a, b_, c: jfl.flash_attention(a, b_, c, scale, blocks), q, k, v)
        grads = vjp(do)
    z = np.asarray(m).reshape(b, h, lq, -1)[..., 0] + np.log(np.asarray(l).reshape(b, h, lq, -1)[..., 0])
    return shape, arrays, [np.asarray(o), z, *map(np.asarray, grads)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def jax_op(request):
    return _jax_op(request.param)


@pytest.fixture(scope="module", params=WIDE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def jax_op_wide(request):
    return _jax_op(request.param)


def test_model_of_the_split_tf32_bodies_matches_the_jax_op(jax_op):
    (b, h, lq, lk, d), arrays, want = jax_op
    plan = fa.flash_f32_plan(b, h, lq, lk, d)
    q, k, v, do = map(torch.from_numpy, arrays)
    scale = d ** -0.5
    o, z = model_fwd(q, k, v, scale, plan.fwd.tile)
    grads = model_bwd(q, k, v, o, z, do, scale, plan.dkdv.tile, plan.dq.tile)
    for name, got, w in zip(("o", "z", "dq", "dk", "dv"), (o, z, *grads), want):
        assert got.shape == w.shape and _rel(got.numpy(), w) <= REL, name


def test_model_of_the_wide_bodies_matches_the_jax_op(jax_op_wide):
    """At D = 256 and 512, ragged: the plan's column shares (clusters of
    two to eight blocks), partial scores summed in rank order, its tiles
    and three passes, within 1e-4 of the JAX op's largest value."""
    (b, h, lq, lk, d), arrays, want = jax_op_wide
    plan = fa.flash_f32_plan(b, h, lq, lk, d)
    assert all(t.cluster == d // t.share >= 2 for t in (plan.fwd, plan.dkdv, plan.dq))
    q, k, v, do = map(torch.from_numpy, arrays)
    scale = d ** -0.5
    o, z = model_fwd_wide(q, k, v, scale, plan.fwd.tile, plan.fwd.share)
    grads = model_bwd_wide(q, k, v, o, z, do, scale, (plan.dkdv.share, plan.dkdv.tile),
                           (plan.dq.share, plan.dq.tile))
    for name, got, w in zip(("o", "z", "dq", "dk", "dv"), (o, z, *grads), want):
        assert got.shape == w.shape and _rel(got.numpy(), w) <= REL, name


def test_rna_split_is_exact_to_two_to_the_minus_21():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(1 << 16) * np.exp(rng.uniform(-20, 20, 1 << 16)))
                         .astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    assert torch.equal(lo.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11
    # ties round away from zero: 1 + 2^-11 (half a TF32 ulp) rounds up, as -(1 + 2^-11) down
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32_rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("passes", [3, 1])
def test_one_tf32_pass_misses_the_float32_bar(passes):
    """At (1, 1, 512, 512, 64) the three passes hold every output within
    1e-4 of the float32 plain versions; one pass does not: the reason the
    bodies take three."""
    b, h, lq, lk, d = 1, 1, 512, 512, 64
    q, k, v, do = map(torch.from_numpy, _inputs(b, h, lq, lk, d, seed=11))
    scale = d ** -0.5
    plan = fa.flash_f32_plan(b, h, lq, lk, d)
    o_p, z_p = fl.flash_attention_res_plain(q.double(), k.double(), v.double(), scale)
    want = [o_p, z_p, *fl.flash_attention_bwd_plain(q.double(), k.double(), v.double(), o_p,
                                                    z_p, do.double(), scale)]
    o, z = model_fwd(q, k, v, scale, plan.fwd.tile, passes)
    got = [o, z, *model_bwd(q, k, v, o, z, do, scale, plan.dkdv.tile, plan.dq.tile, passes)]
    worst = max(_rel(g.numpy(), w.numpy()) for g, w in zip(got, want))
    if passes == 3:
        assert worst <= REL / 10
    else:
        assert worst > REL
