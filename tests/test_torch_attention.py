"""The port's plain flash attention, unpacked and packed-QKV, forward and
backward, against the JAX package's flash_blc Pallas kernels (interpret
mode): float32 within 1e-4, bf16 within the JAX flash tests' 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops.flash_blc import flash_attention_blc, flash_attention_qkv
from vqvae_from_gaussian_vae_tpu.ops.flash_blc import sdpa_token_major as jax_sdpa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SHAPES = [(2, 128, 4, 32), (1, 128, 2, 64), (2, 128, 1, 128)]  # (B, L, H, D)


def _qkv(b, l, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, c)).astype(np.float32) for _ in range(3)]


def _cast(arrays, dtype):
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jt) for a in arrays], [torch.from_numpy(a).to(tt) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,d", SHAPES)
def test_plain_flash_matches_jax_kernel(b, l, h, d, dtype):
    (jq, jk, jv), (q, k, v) = _cast(_qkv(b, l, h * d, seed=h), dtype)
    scale = d ** -0.5
    got = fa.flash_attention_plain(q, k, v, scale, h)
    want = flash_attention_blc(jq, jk, jv, scale, h, True)
    assert got.shape == (b, l, h * d) and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(fa.flash_attention(q, k, v, scale, h), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_token_major_matches_jax(dtype):
    """The front door the UNet AttnBlock calls, (B, L, H, D) in."""
    b, l, h, d = 2, 128, 1, 64
    (jq, jk, jv), (q, k, v) = _cast(_qkv(b, l, h * d, seed=7), dtype)
    shape = (b, l, h, d)
    got = fa.sdpa_token_major(q.reshape(shape), k.reshape(shape), v.reshape(shape))
    want = jax_sdpa(jq.reshape(shape), jk.reshape(shape), jv.reshape(shape))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,d", [(2, 128, 2, 64), (1, 256, 3, 128)])
def test_plain_packed_flash_matches_jax_kernel(b, l, h, d, dtype):
    """q | k | v read from one (B, L, 3C) projection output."""
    (jqkv,), (qkv,) = _cast([np.concatenate(_qkv(b, l, h * d, seed=d), axis=-1)], dtype)
    scale = d ** -0.5
    got = fa.flash_attention_qkv_plain(qkv, scale, h)
    want = flash_attention_qkv(jqkv, scale, h, True)
    assert got.shape == (b, l, h * d) and got.dtype == qkv.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(fa.flash_attention_qkv(qkv, scale, h), got)
    q, k, v = qkv.chunk(3, dim=-1)
    assert torch.equal(fa.flash_attention_plain(q, k, v, scale, h), got)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 64, 64), dtype=torch.bfloat16)
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q, 0.125, 1)
    assert fa.flash_attention_cuda.launches == before


def test_packed_kernel_wrapper_refuses_cpu_tensors():
    before = fa.flash_attention_qkv_cuda.launches
    with pytest.raises(ValueError):
        fa.flash_attention_qkv_cuda(torch.zeros((1, 64, 192), dtype=torch.bfloat16), 0.125, 1)
    assert fa.flash_attention_qkv_cuda.launches == before


@pytest.mark.parametrize("launch", ["unpacked", "packed", "packed_res", "packed_bwd"])
def test_kernel_launches_refuse_grad_outside_autograd(launch):
    """A direct launch on a tensor that wants a gradient raises before it
    looks at the device: the unpacked entry and the packed inference form
    have no backward, and the training form and the backward run only
    inside the packed entry's autograd Function, with grad off."""
    qkv = torch.zeros((1, 64, 192), dtype=torch.bfloat16, requires_grad=True)
    o, z = torch.zeros((1, 64, 64), dtype=torch.bfloat16), torch.zeros((1, 1, 64))
    calls = {"unpacked": lambda: fa.flash_attention_cuda(o, o, qkv[..., :64], 0.125, 1),
             "packed": lambda: fa.flash_attention_qkv_cuda(qkv, 0.125, 1),
             "packed_res": lambda: fa.flash_attention_qkv_res_cuda(qkv, 0.125, 1),
             "packed_bwd": lambda: fa.flash_attention_qkv_bwd_cuda(qkv, o, z, o, 0.125, 1)}
    with pytest.raises(RuntimeError, match="cut off from autograd"):
        calls[launch]()
    with torch.no_grad(), pytest.raises(ValueError):  # then the CPU tensor is refused
        calls[launch]()


def _np(t):
    return t.float().numpy()


def test_plain_packed_flash_bwd_matches_jax_kernel_vjp():
    """The port's plain training forward (o, z) and plain backward (dqkv)
    against the JAX packed entry and its VJP (interpret mode), bf16 at
    (1, 256, 4, 64); the bar is the JAX flash tests' max error over max
    |grad| < 2e-2."""
    import jax

    from vqvae_from_gaussian_vae_tpu.ops.flash_blc import _fwd_hpb, _fwd_res_call_packed

    b, l, h, d = 1, 256, 4, 64
    rng = np.random.default_rng(21)
    qkv = rng.standard_normal((b, l, 3 * h * d)).astype(np.float32)
    do = rng.standard_normal((b, l, h * d)).astype(np.float32)
    jqkv, jdo = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(do, jnp.bfloat16)
    tqkv, tdo = torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(do).to(torch.bfloat16)
    sm = d ** -0.5

    o_p, z_p = fa.flash_attention_qkv_res_plain(tqkv, sm, h)
    jo, jz = _fwd_res_call_packed(jqkv, sm, h, True)
    np.testing.assert_allclose(_np(o_p), np.asarray(jo, np.float32), atol=2e-2, rtol=2e-2)
    hpb = _fwd_hpb(l, h, d, 2)  # z lanes: head within its group, 128 lanes a group
    lanes = [(hh // hpb) * 128 + hh % hpb for hh in range(h)]
    jz_bhl = np.asarray(jz, np.float32)[..., lanes].transpose(0, 2, 1)
    np.testing.assert_allclose(z_p.numpy(), jz_bhl, atol=1e-3, rtol=1e-4)

    _, vjp = jax.vjp(lambda a: flash_attention_qkv(a, sm, h, True), jqkv)
    (want,) = vjp(jdo)
    got = fa.flash_attention_qkv_bwd_plain(tqkv, o_p, z_p, tdo, sm, h)
    assert got.shape == tqkv.shape and got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    for name, g, w in zip("qkv", np.split(_np(got), 3, axis=-1), np.split(want, 3, axis=-1)):
        rel = float(np.abs(g - w).max() / np.abs(w).max())
        assert rel < 2e-2, f"d{name}: {rel}"


def test_packed_flash_autograd_function_matches_torch_autograd():
    """flash_attention_qkv under autograd (the training forward and the
    plain backward on the CPU) against torch autograd of the plain forward,
    float32 operands in bf16-exact values."""
    qkv = torch.from_numpy(np.random.default_rng(22).standard_normal((1, 64, 3 * 128))
                           .astype(np.float32)).to(torch.bfloat16)
    a = qkv.clone().requires_grad_()
    fa.flash_attention_qkv(a, 0.125, 2).float().square().sum().backward()
    ref = qkv.float().requires_grad_()
    q, k, v = (t.reshape(1, 64, 2, 64) for t in ref.chunk(3, dim=-1))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125, dim=-1)
    torch.einsum("bhqk,bkhd->bqhd", p, v).square().sum().backward()
    rel = float((a.grad.float() - ref.grad).abs().max() / ref.grad.abs().max())
    assert rel < 2e-2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpacked_flash_autograd_matches_jax_vjp(dtype):
    """flash_attention under autograd (the training forward and the plain
    backward on the CPU: the UNet AttnBlock's path) against jax.grad of
    flash_attention_blc (its _fwd_res_call and _bwd_call kernels, interpret
    mode) at the AttnBlock's head layout, H 1, D 512, L 128; and the plain
    z against the JAX forward's z lane.  The bar: max error over max |grad|,
    1e-4 (float32) or the JAX flash tests' 2e-2 (bf16)."""
    import jax

    from vqvae_from_gaussian_vae_tpu.ops.flash_blc import _fwd_res_call

    b, l, h, d = 1, 128, 1, 512
    sm = d ** -0.5
    arrays = _qkv(b, l, h * d, seed=31) + [np.random.default_rng(32).standard_normal(
        (b, l, h * d)).astype(np.float32)]
    (jq, jk, jv, jdo), (q, k, v, do) = _cast(arrays, dtype)
    o_p, z_p = fa.flash_attention_res_plain(q, k, v, sm, h)
    _, jz = _fwd_res_call(jq, jk, jv, sm, h, True)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(jz, np.float32)[..., :h].transpose(0, 2, 1),
                               atol=1e-3, rtol=1e-4)

    _, vjp = jax.vjp(lambda a, b_, c: flash_attention_blc(a, b_, c, sm, h, True), jq, jk, jv)
    want = vjp(jdo)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, sm, h)
    assert type(out.grad_fn).__name__.startswith("_FlashFn")
    assert torch.equal(out.detach(), o_p)
    out.backward(do)
    for name, t, w in zip("qkv", leaves, want):
        w = np.asarray(w, np.float32)
        assert t.grad.dtype == t.dtype
        rel = float(np.abs(_np(t.grad) - w).max() / np.abs(w).max())
        assert rel < TOL[dtype], f"d{name}: {rel}"
