"""The port's resample backward against the JAX package's, in float32.

The port's downsample and upsample ops, under autograd, run their autograd
Functions (the plain versions on the CPU); their gradients, plain and with
the deferred add, with a random cotangent on the output and on the
GroupNorm statistics, are held to ``jax.grad`` of the JAX custom-VJP ops,
whose backward runs the Pallas dgrad / wgrad kernels in interpret mode.
The plain dgrad and wgrad are also held to those Pallas kernels directly,
with row bands small enough that every kernel runs several (the band
halos and the wgrad's accumulation across bands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_from_gaussian_vae_tpu.ops import downsample_conv as jdown
from vqvae_from_gaussian_vae_tpu.ops import upsample_conv as jup
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up

TOL = 3e-4  # float32, the bar of the JAX package's own tests/test_fused_train.py


def _arrays(shape, o, op, with_add, seed):
    """x, add, w, bias and the cotangents of y and of the statistics."""
    rng = np.random.default_rng(seed)
    b, h, w_, c = shape
    yshape = (b, 2 * h, 2 * w_, o) if op == "up" else (b, h // 2, w_ // 2, o)

    def normal(s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return {"x": normal(shape), "add": normal(shape) if with_add else None,
            "w": normal((3, 3, c, o), 0.2), "bias": normal((o,), 0.1),
            "gy": normal(yshape), "gs": normal((b, 2, o), 0.01)}


_JAX_OPS = {("down", False): jdown.downsample_conv3x3_gn_vjp,
            ("down", True): jdown.downsample_conv3x3_gn_add_vjp,
            ("up", False): jup.upsample_nearest_conv3x3_gn_vjp,
            ("up", True): jup.upsample_nearest_conv3x3_gn_add_vjp}


def _jax_grads(a, op, with_add):
    fused = _JAX_OPS[(op, with_add)]
    gy, gs = jnp.asarray(a["gy"]), jnp.asarray(a["gs"])
    names = ["x", "add", "w", "bias"] if with_add else ["x", "w", "bias"]

    def loss(*args):
        y, stats = fused(*args)
        return jnp.sum(y * gy) + jnp.sum(stats * gs)

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(*[jnp.asarray(a[n]) for n in names])
    return {n: np.asarray(g) for n, g in zip(names, grads)}


def _port_grads(a, op, with_add):
    fn = down.downsample_conv3x3_gn if op == "down" else up.upsample_nearest_conv3x3_gn
    names = ["x", "add", "w", "bias"] if with_add else ["x", "w", "bias"]
    leaves = {n: torch.from_numpy(a[n]).requires_grad_() for n in names}
    y, stats = fn(leaves["x"], leaves["w"], leaves["bias"], leaves.get("add"))
    assert y.grad_fn is not None and "Fn" in type(y.grad_fn).__name__  # the autograd Function
    ((y * torch.from_numpy(a["gy"])).sum() + (stats * torch.from_numpy(a["gs"])).sum()).backward()
    return {n: t.grad.numpy() for n, t in leaves.items()}


@pytest.mark.parametrize("op,shape,o", [
    ("down", (2, 8, 12, 16), 24),
    ("up", (1, 4, 6, 32), 24),
])
@pytest.mark.parametrize("with_add", [False, True])
def test_autograd_function_matches_jax_vjp(op, shape, o, with_add):
    a = _arrays(shape, o, op, with_add, seed=sum(shape) + o)
    want = _jax_grads(a, op, with_add)
    got = _port_grads(a, op, with_add)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=TOL, rtol=TOL, err_msg=name)
    if with_add:
        np.testing.assert_array_equal(got["x"], got["add"])


def _hwbc(a):
    return jnp.transpose(jnp.asarray(a), (1, 2, 0, 3))


def _bhwc(a):
    return np.asarray(jnp.transpose(a, (2, 0, 1, 3)))


@pytest.mark.parametrize("shape,o,block", [
    ((2, 16, 16, 8), 8, 2),    # 4 bands of 2 cotangent rows
    ((1, 12, 20, 16), 24, 3),  # 2 bands of 3
    ((2, 8, 8, 8), 16, 1),     # 4 bands of 1: every band touches a halo
])
def test_plain_downsample_dgrad_wgrad_match_pallas(shape, o, block):
    a = _arrays(shape, o, "down", False, seed=o + block)
    g = a["gy"]
    got_dx = down.downsample_dgrad_plain(torch.from_numpy(g), torch.from_numpy(a["w"]))
    want_dx = _bhwc(jdown._downsample_dgrad(_hwbc(g), jnp.swapaxes(jnp.asarray(a["w"]), -1, -2),
                                            shape[-1], block, True))
    np.testing.assert_allclose(got_dx.numpy(), want_dx, atol=TOL, rtol=TOL)
    got_dw = down.downsample_wgrad_plain(torch.from_numpy(a["x"]), torch.from_numpy(g))
    want_dw = np.asarray(jdown._downsample_wgrad(_hwbc(a["x"]), _hwbc(g), block, True))
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=2e-3, rtol=2e-4)


@pytest.mark.parametrize("shape,o,block", [
    ((1, 6, 10, 16), 24, 3),   # 2 bands of 3
    ((2, 4, 4, 8), 16, 1),     # 4 bands of 1: the masked halo rows at both ends
])
def test_plain_upsample_dgrad_wgrad_match_pallas(shape, o, block):
    a = _arrays(shape, o, "up", False, seed=o + block)
    g, w = a["gy"], a["w"]
    k22 = up.phase_kernels(torch.from_numpy(w))
    got_dx = up.upsample_dgrad_plain(torch.from_numpy(g), k22)
    jk22, k22_vjp = jax.vjp(jup.phase_kernels, jnp.asarray(w))
    want_dx = _bhwc(jup._upsample_dgrad(_hwbc(g), jnp.swapaxes(jk22, -1, -2), shape[-1], block,
                                        True))
    np.testing.assert_allclose(got_dx.numpy(), want_dx, atol=TOL, rtol=TOL)
    got_dk22 = up.upsample_wgrad_plain(torch.from_numpy(a["x"]), torch.from_numpy(g))
    want_dk22 = jup._upsample_wgrad(_hwbc(a["x"]), _hwbc(g), block, True)
    np.testing.assert_allclose(got_dk22.numpy(), np.asarray(want_dk22), atol=2e-3, rtol=2e-4)
    (want_dw,) = k22_vjp(want_dk22)
    np.testing.assert_allclose(up.phase_kernels_vjp(got_dk22).numpy(), np.asarray(want_dw),
                               atol=2e-3, rtol=2e-4)


@pytest.mark.parametrize("op", [down.downsample_dgrad_cuda, down.downsample_wgrad_cuda,
                                up.upsample_dgrad_cuda, up.upsample_wgrad_cuda])
def test_backward_kernel_wrappers_refuse_cpu_tensors(op):
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    t = torch.zeros((1, 4, 4, 32), dtype=torch.bfloat16)
    second = torch.zeros((3, 3, 32, 32), dtype=torch.bfloat16)
    if op is up.upsample_dgrad_cuda:
        second = torch.zeros((2, 2, 2, 2, 32, 32), dtype=torch.bfloat16)
    elif op in (down.downsample_wgrad_cuda, up.upsample_wgrad_cuda):
        second = t
    before = op.launches
    with pytest.raises(ValueError):
        op(t, second)
    assert op.launches == before
