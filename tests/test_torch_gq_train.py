"""The port's GQ train branch and dual update against the JAX package's:
with eps injected into both (the JAX draw patched to return the numpy
eps), the sample, kl_loss, the bits statistics and the dual update agree
within 1e-6 relative, in the token layout and both spellings of the image
layout, and in every KL band."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_from_gaussian_vae_tpu.quantization import gaussian as jgq
from vqvae_from_gaussian_vae_tpu_torch.quantization import gaussian as gq

TOL = 1e-6


def _posterior(shape, seed):
    """mu, logvar spread so the per-group KL falls below, inside and above
    the target log2(256) = 8 +- 0.5 bits."""
    rng = np.random.default_rng(seed)
    c2 = shape[-1]
    mu = rng.standard_normal(shape[:-1] + (c2 // 2,)) * rng.uniform(0.2, 3.0, shape[:-1] + (1,))
    logvar = rng.uniform(-4.0, 1.0, shape[:-1] + (c2 // 2,))
    return np.concatenate([mu, logvar], axis=-1).astype(np.float32)


@pytest.mark.parametrize("fmt,shape", [("blc", (2, 24, 16)), ("bhwc", (2, 4, 6, 16)),
                                       ("bchw", (2, 6, 4, 16))])  # the UNet configs' format
def test_train_branch_matches_jax(fmt, shape, monkeypatch):
    z = _posterior(shape, seed=1)
    eps = np.random.default_rng(2).standard_normal(shape[:-1] + (shape[-1] // 2,)) \
        .astype(np.float32)
    duals_np = {"lam": 1.3, "lam_min": 0.5, "lam_max": 2.0}
    jmod = jgq.GaussianQuantRegularizer(format=fmt, n_samples=256, group=4, seed=7)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, s, dtype=jnp.float32: jnp.asarray(eps.reshape(s), dtype))
    jduals = {k: jnp.float32(v) for k, v in duals_np.items()}
    jz, jinfo = jmod.apply({}, jnp.asarray(z), train=True, duals=jduals,
                           rngs={"sample": jax.random.PRNGKey(0)})
    port = gq.GaussianQuantRegularizer(format=fmt, n_samples=256, group=4, seed=7)
    pduals = {k: torch.tensor(v, dtype=torch.float32) for k, v in duals_np.items()}
    pz, pinfo = port(torch.from_numpy(z), train=True, duals=pduals, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=TOL, atol=TOL)
    assert set(pinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(float(pinfo[k]), float(jinfo[k]), rtol=TOL, err_msg=k)
    # every band is populated, so all three weights are exercised
    kl = np.asarray(jinfo["bits-min"]), np.asarray(jinfo["bits-max"])
    assert kl[0] < 7.5 and kl[1] > 8.5


def test_kl_loss_is_differentiable():
    z = torch.from_numpy(_posterior((2, 8, 16), seed=3)).requires_grad_()
    port = gq.GaussianQuantRegularizer(format="blc", n_samples=256, group=4, seed=7)
    zhat, info = port(z, train=True, eps=torch.zeros(2, 8, 8))
    (info["kl_loss"] + zhat.sum()).backward()
    assert bool(torch.isfinite(z.grad).all()) and float(z.grad.abs().sum()) > 0


@pytest.mark.parametrize("stats", [
    {"bits-mean": 8.2, "bits-min": 7.2, "bits-max": 9.1},    # every multiplier up
    {"bits-mean": 7.9, "bits-min": 7.6, "bits-max": 8.4},    # every multiplier down
    {"bits-mean": 16.0, "bits-min": 0.1, "bits-max": 40.0},  # at the clamps
])
@pytest.mark.parametrize("duals", [
    {"lam": 1.0, "lam_min": 1.0, "lam_max": 1.0},
    {"lam": 3.0, "lam_min": 1.0005, "lam_max": 999.9},
])
def test_update_duals_matches_jax(stats, duals):
    want = jgq.update_duals({k: jnp.float32(v) for k, v in duals.items()},
                            {k: jnp.float32(v) for k, v in stats.items()}, 8, 0.5, 1.01)
    got = gq.update_duals({k: torch.tensor(v, dtype=torch.float32) for k, v in duals.items()},
                          {k: torch.tensor(v, dtype=torch.float32) for k, v in stats.items()},
                          8, 0.5, 1.01)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL)


def test_init_duals():
    duals = gq.init_duals()
    assert set(duals) == {"lam", "lam_min", "lam_max"}
    assert all(t.dtype == torch.float32 and float(t) == 1.0 for t in duals.values())
