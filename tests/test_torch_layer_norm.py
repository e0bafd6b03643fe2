"""The port's plain LayerNorm and fused add + LayerNorm forward against the
JAX package's Pallas kernels (interpret mode): float32 within 1e-5, bf16
within 2e-2, the summed stream s bit-equal in both dtypes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_from_gaussian_vae_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from vqvae_from_gaussian_vae_tpu.ops.layer_norm import layer_norm_add as jax_layer_norm_add
from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(4, 16, 256), (24, 768)]


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(c) * 0.3 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, d, g, b


def _cast(a, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_layer_norm_matches_jax_kernel(shape, dtype):
    x, _, g, b = _data(shape, seed=len(shape))
    jx, tx = _cast(x, dtype)
    got = ln.layer_norm_plain(tx, torch.from_numpy(g), torch.from_numpy(b))
    want = jax_layer_norm(jx, jnp.asarray(g), jnp.asarray(b), 1e-5, True)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(ln.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b)), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_layer_norm_add_matches_jax_kernel(shape, dtype):
    x, d, g, b = _data(shape, seed=7)
    (jx, tx), (jd, td) = _cast(x, dtype), _cast(d, dtype)
    s, y = ln.layer_norm_add_plain(tx, td, torch.from_numpy(g), torch.from_numpy(b))
    js, jy = jax_layer_norm_add(jx, jd, jnp.asarray(g), jnp.asarray(b), 1e-5, True)
    assert s.dtype == y.dtype == tx.dtype
    # s is x + d rounded once to the IO dtype on both sides
    np.testing.assert_array_equal(_np(s), np.asarray(js, np.float32))
    np.testing.assert_allclose(_np(y), np.asarray(jy, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    s2, y2 = ln.layer_norm_add(tx, td, torch.from_numpy(g), torch.from_numpy(b))
    assert torch.equal(s2, s) and torch.equal(y2, y)


def test_add_variant_takes_statistics_from_the_rounded_sum():
    """LN-add equals LN of its own stored s, not LN of the unrounded sum."""
    x, d, g, b = (torch.from_numpy(a) for a in _data((8, 256), seed=3))
    x16, d16 = x.to(torch.bfloat16), d.to(torch.bfloat16)
    s, y = ln.layer_norm_add_plain(x16, d16, g, b)
    assert torch.equal(y, ln.layer_norm_plain(s, g, b))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    w, b = torch.ones(64), torch.zeros(64)
    before = (ln.layer_norm_cuda.launches, ln.layer_norm_add_cuda.launches)
    with pytest.raises(ValueError):
        ln.layer_norm_cuda(x, w, b)
    with pytest.raises(ValueError):
        ln.layer_norm_add_cuda(x, x, w, b)
    assert (ln.layer_norm_cuda.launches, ln.layer_norm_add_cuda.launches) == before
