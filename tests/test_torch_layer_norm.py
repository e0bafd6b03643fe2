"""The port's plain LayerNorm and fused add + LayerNorm against the JAX
package's Pallas kernels (interpret mode).  Forward: float32 within 1e-5,
bf16 within 2e-2, the summed stream s bit-equal in both dtypes.  Backward
(the JAX custom VJPs): float32 within 1e-4, bf16 within 5e-2."""

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


@pytest.mark.parametrize("launch", ["fwd", "add_fwd", "bwd", "add_bwd"])
def test_kernel_launches_refuse_grad_outside_autograd(launch):
    """A direct launch on tensors that want a gradient raises before it
    looks at the device: its output would be cut off from autograd (the
    autograd Functions call these launches with grad off)."""
    x = torch.zeros((4, 64), requires_grad=True)
    w, b = torch.ones(64), torch.zeros(64)
    calls = {"fwd": lambda: ln.layer_norm_cuda(x, w, b),
             "add_fwd": lambda: ln.layer_norm_add_cuda(x, x, w, b),
             "bwd": lambda: ln.layer_norm_bwd_cuda(x, w, x),
             "add_bwd": lambda: ln.layer_norm_add_bwd_cuda(x, w, x, x)}
    with pytest.raises(RuntimeError, match="cut off from autograd"):
        calls[launch]()
    with torch.no_grad(), pytest.raises(ValueError):  # then the CPU tensor is refused
        calls[launch]()


# --- backward ---------------------------------------------------------------

BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # float32: test_layer_norm_fused.py's bar


def _jax_vjp(fn, primals, cotangent):
    import jax

    _, vjp = jax.vjp(fn, *primals)
    return vjp(cotangent)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_layer_norm_bwd_matches_jax_kernel(dtype):
    x, dy, g, b = _data((64, 256), seed=11)
    (jx, tx), (jdy, tdy) = _cast(x, dtype), _cast(dy, dtype)
    want = _jax_vjp(lambda x_, g_, b_: jax_layer_norm(x_, g_, b_, 1e-5, True),
                    (jx, jnp.asarray(g), jnp.asarray(b)), jdy)
    got = ln.layer_norm_bwd_plain(tx, torch.from_numpy(g), tdy)
    assert got[0].dtype == tx.dtype and got[1].dtype == got[2].dtype == torch.float32
    for p, j in zip(got, want):
        np.testing.assert_allclose(_np(p), np.asarray(j, np.float32),
                                   atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_layer_norm_add_bwd_matches_jax_kernel(dtype):
    """The add variant's backward recomputes the statistics from the saved
    s, adds the cotangent of s to dx and returns dx for both x and d."""
    x, d, g, b = _data((64, 256), seed=12)
    rng = np.random.default_rng(13)
    dy, ds_in = (rng.standard_normal((64, 256)).astype(np.float32) for _ in range(2))
    (jx, tx), (jd, td) = _cast(x, dtype), _cast(d, dtype)
    (jdy, tdy), (jds, tds) = _cast(dy, dtype), _cast(ds_in, dtype)
    want = _jax_vjp(lambda x_, d_, g_, b_: jax_layer_norm_add(x_, d_, g_, b_, 1e-5, True),
                    (jx, jd, jnp.asarray(g), jnp.asarray(b)), (jds, jdy))
    s, _ = ln.layer_norm_add_plain(tx, td, torch.from_numpy(g), torch.from_numpy(b))
    dx, dg, db = ln.layer_norm_bwd_plain(s, torch.from_numpy(g), tdy, ds_in=tds)
    for p, j in zip((dx, dx, dg, db), want):
        np.testing.assert_allclose(_np(p), np.asarray(j, np.float32),
                                   atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("add", [False, True])
def test_autograd_functions_match_torch_autograd_of_the_plain_forward(add):
    """The Functions' backward (the plain backward on the CPU) against
    torch autograd of the plain forward, float32; an unused s gives a zero
    ds_in."""
    x, d, g, b = (torch.from_numpy(a) for a in _data((32, 128), seed=14))
    dy = torch.from_numpy(np.random.default_rng(15).standard_normal((32, 128)).astype(np.float32))
    grads = []
    for fn in ((ln.layer_norm_add, ln.layer_norm_add_plain) if add
               else (ln.layer_norm, ln.layer_norm_plain)):
        leaves = [t.clone().requires_grad_() for t in ((x, d, g, b) if add else (x, g, b))]
        out = fn(*leaves)
        y = out[1] if add else out
        (y * dy).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
