"""The port's plain flash-attention forward against the JAX package's
flash_blc Pallas kernel (interpret mode): float32 within 1e-4, bf16 within
the JAX flash tests' 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_from_gaussian_vae_tpu.ops.flash_blc import flash_attention_blc
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


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 64, 64), dtype=torch.bfloat16)
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q, 0.125, 1)
    assert fa.flash_attention_cuda.launches == before
