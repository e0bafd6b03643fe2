"""The port's training conv (``ops/conv3x3_train.py``) against the JAX
package's custom-VJP ``conv3x3_same_wg``, whose backward runs the Pallas
wgrad kernel in interpret mode off the TPU.

dx, dw and dbias of the port's autograd Function against ``jax.grad`` of
the JAX op within 3e-4 (atol and rtol, the JAX test's bar,
``tests/test_fused_train.py``); the plain wgrad against the Pallas kernel
directly, with row bands small enough that every band meets a halo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_from_gaussian_vae_tpu.ops import conv3x3_train as jconv
from vqvae_from_gaussian_vae_tpu_torch.ops import conv3x3_train as conv

TOL = 3e-4


def _arrays(b, h, w, c, o, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, h, w, c)).astype(np.float32),
            "w": (rng.standard_normal((3, 3, c, o)) * 0.2).astype(np.float32),
            "bias": (rng.standard_normal(o) * 0.1).astype(np.float32),
            "gy": rng.standard_normal((b, h, w, o)).astype(np.float32)}


@pytest.mark.parametrize("b,h,w,c,o", [
    (2, 16, 16, 8, 8),    # the JAX test's shape
    (2, 16, 16, 8, 16),   # C != O
    (1, 8, 12, 16, 8),    # C > O, W != H
])
def test_autograd_function_matches_jax_vjp(b, h, w, c, o):
    a = _arrays(b, h, w, c, o, seed=b + h + c + o)
    gy = jnp.asarray(a["gy"])

    def loss(x, w_, bias):
        return jnp.sum(jconv.conv3x3_same_wg(x, w_, bias) * gy)

    jx, jw, jb = (jnp.asarray(a[k]) for k in ("x", "w", "bias"))
    want_y = np.asarray(jconv.conv3x3_same_wg(jx, jw, jb))
    want = jax.grad(loss, argnums=(0, 1, 2))(jx, jw, jb)
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "w", "bias")]
    y = conv.conv3x3_same_wg(*leaves)
    assert type(y.grad_fn).__name__ == "_Conv3x3WgFnBackward"
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=TOL, rtol=TOL)
    (y * torch.from_numpy(a["gy"])).sum().backward()
    for t, g, name in zip(leaves, want, ("dx", "dw", "dbias")):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("b,h,w,c,o,block", [
    (2, 8, 8, 8, 16, 2),     # 4 bands of 2 rows
    (1, 6, 10, 16, 8, 1),    # 6 bands of 1: every band reads both halos
])
def test_plain_wgrad_matches_pallas(b, h, w, c, o, block):
    a = _arrays(b, h, w, c, o, seed=block + c)
    got = conv.conv3x3_wgrad_plain(torch.from_numpy(a["x"]), torch.from_numpy(a["gy"]))
    hwbc = (1, 2, 0, 3)
    want = jconv._conv3x3_wgrad(jnp.transpose(jnp.asarray(a["x"]), hwbc),
                                jnp.transpose(jnp.asarray(a["gy"]), hwbc), block, True)
    assert got.shape == (3, 3, c, o) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-4)


def test_wgrad_kernel_wrapper_refuses_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    t = torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16)
    before = conv.conv3x3_wgrad_cuda.launches
    with pytest.raises(ValueError):
        conv.conv3x3_wgrad_cuda(t, t)
    assert conv.conv3x3_wgrad_cuda.launches == before
