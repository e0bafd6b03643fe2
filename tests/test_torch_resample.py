"""The port's plain fused-resample ops against the JAX package's Pallas
kernels (interpret mode), in float32 within the JAX kernel tests' 1e-4.

These plain versions are what the CUDA kernels are held to on the card, and
what the port runs for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models.unet import group_norm_from_stats as jax_gn_from_stats
from vqvae_from_gaussian_vae_tpu.ops.downsample_conv import downsample_conv3x3_gn as jax_down
from vqvae_from_gaussian_vae_tpu.ops.upsample_conv import phase_kernels as jax_phase_kernels
from vqvae_from_gaussian_vae_tpu.ops.upsample_conv import upsample_nearest_conv3x3 as jax_up_nostats
from vqvae_from_gaussian_vae_tpu.ops.upsample_conv import upsample_nearest_conv3x3_gn as jax_up
from vqvae_from_gaussian_vae_tpu_torch.models.unet import group_norm_from_stats
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up

TOL = 1e-4  # float32, as the JAX package's own kernel tests


def _inputs(shape, o, with_add, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    add = rng.standard_normal(shape).astype(np.float32) if with_add else None
    w = (rng.standard_normal((3, 3, c, o)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((o,)).astype(np.float32)
    return x, add, w, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _check(got, want):
    y, stats = got
    jy, jstats = want
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,o,with_add", [
    ((2, 8, 12, 16), 24, False),
    ((2, 8, 8, 16), 16, True),
    ((1, 16, 16, 8), 8, True),
])
def test_plain_downsample_matches_jax_kernel(shape, o, with_add):
    x, add, w, bias = _inputs(shape, o, with_add, seed=0)
    got = down.downsample_conv3x3_gn_plain(_t(x), _t(w), _t(bias), _t(add))
    want = jax_down(_j(x), _j(w), _j(bias), add=_j(add), interpret=True)
    assert got[0].shape == (shape[0], shape[1] // 2, shape[2] // 2, o)
    assert got[1].shape == (shape[0], 2, o) and got[1].dtype == torch.float32
    _check(got, want)
    # the public op takes the plain version for CPU tensors
    routed = down.downsample_conv3x3_gn(_t(x), _t(w), _t(bias), _t(add))
    assert torch.equal(routed[0], got[0]) and torch.equal(routed[1], got[1])


@pytest.mark.parametrize("shape,o,with_add", [
    ((2, 8, 12, 16), 16, False),
    ((2, 8, 8, 16), 16, True),
    ((1, 4, 4, 32), 24, True),
])
def test_plain_upsample_matches_jax_kernel(shape, o, with_add):
    x, add, w, bias = _inputs(shape, o, with_add, seed=1)
    got = up.upsample_nearest_conv3x3_gn_plain(_t(x), _t(w), _t(bias), _t(add))
    want = jax_up(_j(x), _j(w), _j(bias), add=_j(add), interpret=True)
    assert got[0].shape == (shape[0], 2 * shape[1], 2 * shape[2], o)
    _check(got, want)
    routed = up.upsample_nearest_conv3x3_gn(_t(x), _t(w), _t(bias), _t(add))
    assert torch.equal(routed[0], got[0]) and torch.equal(routed[1], got[1])


@pytest.mark.parametrize("shape,o", [((2, 8, 12, 16), 16), ((1, 4, 4, 32), 24)])
def test_upsample_without_statistics_matches_jax_kernel(shape, o):
    """``upsample_nearest_conv3x3``: the fused upsample without its
    statistics epilogue, on a CPU tensor its plain version."""
    x, _, w, bias = _inputs(shape, o, False, seed=2)
    got = up.upsample_nearest_conv3x3(_t(x), _t(w), _t(bias))
    want = jax_up_nostats(_j(x), _j(w), _j(bias), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert torch.equal(got, up.upsample_nearest_conv3x3_gn_plain(_t(x), _t(w), _t(bias))[0])


def test_phase_kernels_match_jax():
    w = np.random.default_rng(2).standard_normal((3, 3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(up.phase_kernels(torch.from_numpy(w)).numpy(),
                               np.asarray(jax_phase_kernels(jnp.asarray(w))), rtol=1e-6)


def test_group_norm_from_stats_matches_jax():
    rng = np.random.default_rng(3)
    x, _, w, bias = _inputs((2, 8, 8, 32), 32, False, seed=3)
    y, stats = down.downsample_conv3x3_gn_plain(_t(x), _t(w), _t(bias))
    scale = rng.standard_normal((32,)).astype(np.float32)
    shift = rng.standard_normal((32,)).astype(np.float32)
    got = group_norm_from_stats(y, stats, _t(scale), _t(shift), num_groups=4)
    want = jax_gn_from_stats(jnp.asarray(y.numpy()), jnp.asarray(stats.numpy()),
                             jnp.asarray(scale), jnp.asarray(shift), num_groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op", [down.downsample_conv3x3_gn_cuda,
                                up.upsample_nearest_conv3x3_gn_cuda])
def test_kernel_wrappers_refuse_cpu_tensors(op):
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    x = torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 32, 128), dtype=torch.bfloat16)
    before = op.launches
    with pytest.raises(ValueError):
        op(x, w, torch.zeros(128))
    assert op.launches == before


@pytest.mark.parametrize("op", [down.downsample_conv3x3_gn_cuda,
                                up.upsample_nearest_conv3x3_gn_cuda])
def test_kernel_wrappers_refuse_grad(op):
    """A direct launch of a forward kernel has no backward wired to it (the
    public op's autograd Function has): asked for a gradient, the wrapper
    raises rather than return a tensor cut off from autograd."""
    x = torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 32, 128), dtype=torch.bfloat16, requires_grad=True)
    before = op.launches
    with pytest.raises(RuntimeError, match="cut off from autograd"):
        op(x, w, torch.zeros(128))
    assert op.launches == before
