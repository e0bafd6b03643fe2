"""The port's GQ search and regularizer eval branch against the JAX package.

Indices must be equal; a differing index is allowed only where the float64
oracle shows the two codes tie to within NEAR_TIE (relative), since the two
float32 products sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops.gq_pallas import gq_argmax_pallas
from vqvae_from_gaussian_vae_tpu.ops.gq_search import gq_search as jax_gq_search
from vqvae_from_gaussian_vae_tpu.ops.gq_search import score_operands as jax_score_operands
from vqvae_from_gaussian_vae_tpu.quantization.gaussian import (
    GaussianQuantRegularizer as JaxGQ)
from vqvae_from_gaussian_vae_tpu_torch.ops.codebook import prior_samples
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import (
    argmax_blocked, gq_scores_reference, gq_search, score_operands)
from vqvae_from_gaussian_vae_tpu_torch.quantization.gaussian import GaussianQuantRegularizer

NEAR_TIE = 1e-5  # relative float64 score gap under which two codes are a tie


def _posterior(rows, g, seed):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((rows, g)).astype(np.float32)
    std = np.exp(0.5 * np.clip(rng.standard_normal((rows, g)), -3, 1)).astype(np.float32)
    return mu, std


def assert_indices_match(got, want, mu, std, cb):
    """Equal, or a float64-proven near-tie for every differing row."""
    got, want = np.asarray(got), np.asarray(want)
    for r in np.nonzero(got != want)[0]:
        s = gq_scores_reference(mu[r:r + 1], std[r:r + 1], cb[[got[r], want[r]]])[0]
        assert abs(s[0] - s[1]) <= NEAR_TIE * max(1.0, abs(s[1])), (r, got[r], want[r], s)


def test_score_operands_match_jax():
    mu, std = _posterior(64, 16, 0)
    cb = prior_samples(1024, 16, 42)
    a, b = score_operands(torch.from_numpy(mu), torch.from_numpy(std), torch.tensor(cb), 1.0)
    ja, jb = jax_score_operands(jnp.asarray(mu), jnp.asarray(std), jnp.asarray(cb), 1.0)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("rows,n,g", [(300, 65536, 16), (70, 300, 8), (64, 1024, 4)])
def test_plain_search_matches_jax_xla_and_pallas(rows, n, g):
    mu, std = _posterior(rows, g, 1)
    cb = prior_samples(n, g, 42)
    got = gq_search(torch.from_numpy(mu), torch.from_numpy(std), torch.tensor(cb),
                    backend="auto").numpy()
    want = np.asarray(jax_gq_search(jnp.asarray(mu), jnp.asarray(std), jnp.asarray(cb),
                                    backend="xla"))
    assert_indices_match(got, want, mu, std, cb)
    ja, jb = jax_score_operands(jnp.asarray(mu), jnp.asarray(std), jnp.asarray(cb), 1.0)
    pallas = np.asarray(gq_argmax_pallas(ja, jb, block_r=64, block_n=512, interpret=True))
    assert_indices_match(got, pallas, mu, std, cb)


def test_plain_search_first_max_tie_break():
    # duplicate codebook columns force exact ties; the first one must win,
    # also across a block boundary
    a = torch.ones((8, 4))
    col = np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32)
    b = torch.from_numpy(np.concatenate([col, col], axis=1))
    got = argmax_blocked(a, b, block_r=8, block_n=16).numpy()
    dense = np.asarray(jnp.argmax(jnp.asarray(a.numpy()) @ jnp.asarray(b.numpy()), axis=1))
    np.testing.assert_array_equal(got, dense)
    assert (got < 16).all()
    pallas = np.asarray(gq_argmax_pallas(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                         block_r=8, block_n=16, interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_backend_names():
    mu, std = _posterior(16, 4, 2)
    cb = torch.tensor(prior_samples(256, 4, 7))
    args = (torch.from_numpy(mu), torch.from_numpy(std), cb)
    ref = gq_search(*args, backend="torch")
    for name in ("auto", "pallas", "cuda", "xla"):
        assert torch.equal(gq_search(*args, backend=name), ref)
    with pytest.raises(ValueError):
        gq_search(*args, backend="nope")


def test_regularizer_eval_and_dequant_match_jax():
    """Full 65536 x 16 codebook, 2 x 10 x 10 latents with 2 index groups."""
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 10, 10, 64)).astype(np.float32)
    z[..., 32:] = np.clip(z[..., 32:], -3, 1)  # logvar half
    eps = rng.standard_normal((2, 100, 32)).astype(np.float32)

    jmod = JaxGQ(format="bchw", n_samples=65536, group=16, backend="xla")
    jz, jinfo = jmod.apply({}, jnp.asarray(z), train=False,
                           rngs={"sample": jax.random.PRNGKey(0)})
    jidx = np.array(jinfo["indices"])

    port = GaussianQuantRegularizer(format="bchw", n_samples=65536, group=16)
    pz, info = port(torch.from_numpy(z), eps=torch.from_numpy(eps))
    idx = info["indices"].numpy()
    assert idx.shape == jidx.shape == (2, 10, 10, 2)
    assert idx.dtype == np.int32

    mu = z[..., :32].reshape(2, 100, 16, 2).transpose(0, 1, 3, 2).reshape(-1, 16)
    std = np.exp(0.5 * z[..., 32:]).reshape(2, 100, 16, 2).transpose(0, 1, 3, 2).reshape(-1, 16)
    cb = prior_samples(65536, 16, 42)
    assert_indices_match(idx.reshape(-1), jidx.reshape(-1), mu, std, cb)

    # dequant of the same indices is exact in both packages
    deq = port.dequant(torch.from_numpy(jidx)).numpy()
    jdeq = np.asarray(jmod.apply({}, jnp.asarray(jidx), method="dequant"))
    np.testing.assert_array_equal(deq, jdeq)
    np.testing.assert_array_equal(port.dequant(info["indices"]).numpy(), pz.numpy())
    # zhat_noquant = mu + eps * std with the injected eps
    want = z[..., :32] + eps.reshape(2, 10, 10, 32) * np.exp(0.5 * z[..., 32:])
    np.testing.assert_allclose(info["zhat_noquant"].numpy(), want, rtol=1e-6, atol=1e-6)


def test_regularizer_train_branch_raises():
    """The train branch returns the reparameterised sample and the KL
    statistics (tests/test_torch_gq_train.py holds it to the JAX package);
    it still refuses a posterior whose channels do not split in two."""
    port = GaussianQuantRegularizer(format="bchw", n_samples=256, group=4, seed=7)
    eps = torch.ones(1, 2, 2, 4)
    zhat, info = port(torch.zeros(1, 2, 2, 8), train=True, eps=eps)
    assert torch.equal(zhat, eps) and float(info["bits-mean"]) == 0.0
    with pytest.raises(RuntimeError):
        port(torch.zeros(1, 2, 2, 7), train=True, eps=eps)
