"""The port's head-major flash attention (``ops/flash_attention_lean.py``)
against the JAX package's ``ops/flash_attention.py``.

The port's plain versions are held to the pure-JAX oracles of the installed
upstream module (``mha_reference_no_custom_vjp``, ``mha_reference_bwd``),
the float32 op to the JAX op itself (its Pallas kernels in TPU interpret
mode), its output's shape and dtype to ``jax.eval_shape`` of the JAX op,
and its ``ValueError``s to the JAX op's over a grid of block sizes and
lengths.  Inputs come from a numpy seed.  Bars: float32 o and z within
1e-5 of the oracle's largest value, gradients within 1e-4 of their largest
value (float32 sums in another order), and within 1e-5 of the JAX op's;
bf16 o within the JAX flash test's 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as upstream

from vqvae_from_gaussian_vae_tpu.ops import flash_attention as jfl
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl

FWD_REL = 1e-5
GRAD_REL = 1e-4
BF16_ATOL = 2e-2
# (B, H, Lq, Lk, D): the JAX test's shape, and a ragged one (Lq != Lk, no
# length a multiple of 64)
SHAPES = [(2, 4, 512, 512, 64), (2, 2, 200, 328, 256)]


def _blocks(cls, lq, lk):
    """Block sizes that every check accepts at (lq, lk)."""
    bq, bk = min(lq, 256), lk if lk % 512 else 512
    return cls(block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
               block_q_major_dkv=lq, block_k_major_dkv=bk, block_k_dkv=bk, block_q_dkv=lq,
               block_k_major_dq=bk, block_k_dq=bk, block_q_dq=lq)


def _inputs(b, h, lq, lk, d, seed, n=4):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, lq, d), (b, h, lk, d), (b, h, lk, d), (b, h, lq, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes[:n]]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,h,lq,lk,d", SHAPES)
def test_plain_versions_match_the_upstream_oracles(b, h, lq, lk, d):
    q, k, v, do = _inputs(b, h, lq, lk, d, seed=lq)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))

    # the forward at D^-0.5: o, and z = m + ln l of the oracle's residuals
    scale = d ** -0.5
    o, z = fl.flash_attention_res_plain(tq, tk, tv, scale)
    o_j, l_j, m_j = upstream.mha_reference_no_custom_vjp(jq, jk, jv, sm_scale=scale,
                                                         save_residuals=True)
    assert _rel(o.numpy(), o_j) <= FWD_REL
    assert _rel(z.numpy(), m_j + jnp.log(l_j)) <= FWD_REL

    # the gradients at D^-0.5 against jax.vjp of the oracle
    _, vjp = jax.vjp(lambda a, b_, c: upstream.mha_reference_no_custom_vjp(
        a, b_, c, sm_scale=scale), jq, jk, jv)
    for got, want in zip(fl.flash_attention_bwd_plain(tq, tk, tv, o, z, tdo, scale), vjp(jdo)):
        assert got.shape == want.shape and _rel(got.numpy(), want) <= GRAD_REL

    # the gradients at sm_scale = 1 against the oracle's own backward, fed
    # the oracle's o, l and m
    o1_j, l1_j, m1_j = upstream.mha_reference_no_custom_vjp(jq, jk, jv, save_residuals=True)
    want = upstream.mha_reference_bwd(jq, jk, jv, None, None, o1_j, l1_j, m1_j, jdo)[:3]
    z1 = torch.from_numpy(np.array(m1_j + jnp.log(l1_j)))
    got = fl.flash_attention_bwd_plain(tq, tk, tv, torch.from_numpy(np.array(o1_j)), z1, tdo,
                                       1.0)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= GRAD_REL


@pytest.mark.parametrize("b,h,lq,lk,d", SHAPES)
def test_bf16_forward_matches_einsum_and_the_jax_op_shape(b, h, lq, lk, d):
    q, k, v = _inputs(b, h, lq, lk, d, seed=7, n=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    scale = d ** -0.5
    got = fl.flash_attention(tq, tk, tv, scale, _blocks(fl.BlockSizes, lq, lk))

    attn = jnp.einsum("bhqd,bhkd->bhqk", jq, jk).astype(jnp.float32) * scale
    p = jax.nn.softmax(attn, -1).astype(jv.dtype)
    want = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", p, jv), np.float32)
    assert float(np.abs(got.float().numpy() - want).max()) < BF16_ATOL

    for dtype, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        sds = [jax.ShapeDtypeStruct(a.shape, dtype) for a in (q, k, v)]
        out = jax.eval_shape(lambda a, b_, c: jfl.flash_attention(
            a, b_, c, scale, _blocks(jfl.BlockSizes, lq, lk)), *sds)
        port = fl.flash_attention(tq.to(tdt), tk.to(tdt), tv.to(tdt), scale,
                                  _blocks(fl.BlockSizes, lq, lk))
        assert tuple(port.shape) == out.shape and str(port.dtype).split(".")[1] == out.dtype.name


@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 2, 256, 256, 64), (1, 1, 128, 384, 128)])
def test_float32_op_matches_the_jax_op(b, h, lq, lk, d):
    """The float32 op (its plain training forward and backward, what the
    float32 kernels are held to on the card) against the JAX op itself in
    float32, its Pallas kernels run in TPU interpret mode: o and each
    gradient within 1e-5 of its largest value."""
    q, k, v, do = _inputs(b, h, lq, lk, d, seed=5)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        o_j, vjp = jax.vjp(lambda a, b_, c: jfl.flash_attention(
            a, b_, c, scale, _blocks(jfl.BlockSizes, lq, lk)), *map(jnp.asarray, (q, k, v)))
        grads_j = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fl.flash_attention(*leaves, scale, _blocks(fl.BlockSizes, lq, lk))
    o.backward(torch.from_numpy(do))
    assert o.dtype == torch.float32 and _rel(o.detach().numpy(), o_j) <= FWD_REL
    for leaf, want in zip(leaves, grads_j):
        assert _rel(leaf.grad.numpy(), want) <= FWD_REL


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _outcome(fn) -> str:
    """"ok", "value" (a ValueError: the op's contract) or "tiling" (another
    error, raised inside the TPU kernel bodies: a k block that is not a
    multiple of the 128 lanes)."""
    try:
        fn()
    except ValueError:
        return "value"
    except (TypeError, NotImplementedError):
        return "tiling"
    return "ok"


def _block_grid(lq, lk):
    """BlockSizes arguments around (lq, lk): dividing, non-dividing, too
    large, minor above major, and without the backward blocks."""
    grid = []
    for bq in dict.fromkeys((128, 200, 384, lq)):
        for bkm, bk in dict.fromkeys(((512, 512), (256, 128), (128, 256), (200, 200), (lk, lk))):
            grid.append(dict(block_q=bq, block_k_major=bkm, block_k=bk, block_b=1))
            for bqb in dict.fromkeys((200, lq)):
                grid.append(dict(block_q=bq, block_k_major=bkm, block_k=bk, block_b=1,
                                 block_q_major_dkv=bqb, block_k_major_dkv=bkm, block_k_dkv=bk,
                                 block_q_dkv=bqb, block_k_major_dq=bkm, block_k_dq=bk,
                                 block_q_dq=bqb))
    grid.append(dict(block_q=lq, block_k_major=lk, block_k=lk, block_b=2))  # block_b > batch
    return grid


@pytest.mark.parametrize("lq,lk", [(512, 512), (384, 512), (256, 512), (200, 200), (100, 512)])
def test_value_errors_match_the_jax_op(lq, lk):
    """The port raises ValueError exactly where ``jax.eval_shape`` of the JAX
    op, or of its gradient, raises ValueError; and nowhere else.  Where the
    JAX op fails inside its TPU kernel bodies (a k block off the 128 lanes:
    TypeError or NotImplementedError, not a check of the contract), the port,
    whose tiling the block sizes do not set, computes."""
    d = 64
    q, k, v = _inputs(1, 1, lq, lk, d, seed=3, n=3)
    sds = [jax.ShapeDtypeStruct(a.shape, jnp.bfloat16) for a in (q, k, v)]
    seen = set()
    for args in _block_grid(lq, lk):
        if _raises(lambda: jfl.BlockSizes(**args)):
            assert _raises(lambda: fl.BlockSizes(**args)), args
            seen.add("post_init")
            continue
        jbs, pbs = jfl.BlockSizes(**args), fl.BlockSizes(**args)

        def jfwd(a, b_, c):
            return jfl.flash_attention(a, b_, c, d ** -0.5, jbs)

        def jgrad(a, b_, c):
            return jax.grad(lambda *t: jfwd(*t).astype(jnp.float32).sum(), (0, 1, 2))(a, b_, c)

        def pfwd(grad):
            tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(grad)
                          for a in (q, k, v))
            o = fl.flash_attention(tq, tk, tv, d ** -0.5, pbs)
            if grad:
                o.float().sum().backward()

        fwd = _outcome(lambda: jax.eval_shape(jfwd, *sds))
        assert _raises(lambda: pfwd(False)) == (fwd == "value"), (args, fwd)
        grad = fwd if fwd != "ok" else _outcome(lambda: jax.eval_shape(jgrad, *sds))
        assert _raises(lambda: pfwd(True)) == (grad == "value"), (args, grad)
        seen.add(("forward " if fwd != "ok" else "backward ") + grad)
    assert {"post_init", "forward value", "backward value"} <= seen, seen
    # at L = 200 every k block is off the lanes or does not divide
    assert ("backward tiling" if (lq, lk) == (200, 200) else "backward ok") in seen, seen


def test_cpu_autograd_matches_autograd_of_the_plain_forward():
    """The autograd Function (the plain training forward, then the plain
    backward) against torch.autograd through the plain forward."""
    b, h, lq, lk, d = SHAPES[1]
    q, k, v, do = _inputs(b, h, lq, lk, d, seed=11)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tdo = torch.from_numpy(do)
    scale = d ** -0.5
    o = fl.flash_attention(*leaves, scale, _blocks(fl.BlockSizes, lq, lk))
    o.backward(tdo)
    o_ref = fl.flash_attention_res_plain(*ref, scale)[0]
    o_ref.backward(tdo)
    assert torch.equal(o.detach(), o_ref.detach())
    for got, want in zip(leaves, ref):
        assert _rel(got.grad.numpy(), want.grad.numpy()) <= FWD_REL


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 1, 64, 64, 64, 0))
    with pytest.raises(ValueError):
        fl.flash_attention_fwd_cuda(q, k, v, 0.125)
    z = torch.zeros((1, 1, 64))
    with pytest.raises(ValueError):
        fl.flash_attention_bwd_cuda(q, k, v, q, z, do, 0.125)
    assert fl.flash_attention_fwd_cuda.launches == fl.flash_attention_bwd_cuda.launches == 0
