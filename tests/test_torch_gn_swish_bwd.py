"""The port's GroupNorm + swish with its backward (``ops/gn_swish_bwd.py``)
against the JAX package's custom-VJP ``gn_swish``, whose backward runs the
two-phase Pallas kernel in interpret mode.

The four shapes of the JAX test (``tests/test_gn_swish_bwd.py``), each
through both packages from the same numpy draw: dx, dgamma and dbeta within
2e-4 in float32 and 5e-2 in bf16 (atol and rtol), the JAX test's bars; the
forward and its saved statistics against ``_gn_swish_ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops import gn_swish_bwd as jgn
from vqvae_from_gaussian_vae_tpu_torch.ops import gn_swish_bwd as gn

_DTYPES = {"float32": (torch.float32, jnp.float32, 2e-4),
           "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def _arrays(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32) * 2.0,
            (rng.standard_normal(c) * 0.3 + 1.0).astype(np.float32),
            (rng.standard_normal(c) * 0.2).astype(np.float32),
            rng.standard_normal((b, h, w, c)).astype(np.float32))


@pytest.mark.parametrize("b,h,w,c,dtype", [
    (2, 16, 16, 64, "float32"),
    (2, 16, 16, 64, "bfloat16"),
    (1, 32, 8, 128, "bfloat16"),   # several row bands
    (3, 8, 8, 256, "bfloat16"),    # wider channels, odd batch
])
def test_backward_matches_jax_kernel(b, h, w, c, dtype):
    tdt, jdt, tol = _DTYPES[dtype]
    x, scale, bias, dy = _arrays(b, h, w, c)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)

    def loss(x_, s_, b_):
        y = jgn.gn_swish(x_, s_, b_, 32, 1e-6, True)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(), torch.from_numpy(scale).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    y = gn.gn_swish(*leaves)
    assert type(y.grad_fn).__name__ == "_GnSwishFnBackward" and y.dtype == tdt
    (y.float() * torch.from_numpy(dy).to(tdt).float()).sum().backward()
    for t, g, name in zip(leaves, want, ("dx", "dgamma", "dbeta")):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(g, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


def test_forward_and_statistics_match_jax_reference():
    x, scale, bias, _ = _arrays(2, 16, 16, 64, seed=1)
    y, (mean_c, rstd_c) = gn.gn_swish_ref(*map(torch.from_numpy, (x, scale, bias)))
    jy, (jmean, jrstd) = jgn._gn_swish_ref(*map(jnp.asarray, (x, scale, bias)), 32, 1e-6)
    for got, want in ((y, jy), (mean_c, jmean), (rstd_c, jrstd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    # without a gradient the public op is the plain forward
    assert torch.equal(gn.gn_swish(*map(torch.from_numpy, (x, scale, bias))), y)


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    stats, affine = torch.ones((1, 64)), torch.ones(64)
    before = gn.gn_swish_bwd_cuda.launches
    with pytest.raises(ValueError):
        gn.gn_swish_bwd_cuda(x, x, stats, stats, affine, affine)
    assert gn.gn_swish_bwd_cuda.launches == before
