"""The port's codebook must be bit-exact: checkpoints do not store it, so
token indices are portable only if both packages build the same table."""

import os

import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops import codebook as jax_cb
from vqvae_from_gaussian_vae_tpu_torch.ops import codebook as port_cb

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def test_prior_samples_matches_shipped_asset():
    table = port_cb.prior_samples(65536, 16, 42)
    asset = np.load(os.path.join(ASSETS, "prior_samples_n65536_g16_s42.npy"))
    assert table.dtype == np.float32 and table.shape == (65536, 16)
    np.testing.assert_array_equal(table, asset)


@pytest.mark.parametrize("n,g,seed", [(1024, 16, 42), (333, 8, 7), (64, 3, 0)])
def test_generator_matches_jax_package(n, g, seed):
    """The numpy generator (no asset involved) equals the JAX package's."""
    np.testing.assert_array_equal(port_cb.generate(n, g, seed), jax_cb.generate(n, g, seed))


def test_prior_samples_matches_jax_package():
    np.testing.assert_array_equal(port_cb.prior_samples(65536, 16, 42),
                                  jax_cb.prior_samples(65536, 16, 42))


def test_standard_normal_log_prob_matches_jax_package():
    table = port_cb.prior_samples(65536, 16, 42)[:4096]
    got = port_cb.standard_normal_log_prob(table)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_cb.standard_normal_log_prob(table))
