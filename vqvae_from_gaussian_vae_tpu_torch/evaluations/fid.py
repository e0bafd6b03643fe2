"""Frechet Inception Distance on the host.

A copy of ``vqvae_from_gaussian_vae_tpu/evaluations/fid.py`` (numpy and
scipy; the 2048 x 2048 ``sqrtm`` is not a device op):
||mu1 - mu2||^2 + tr(C1 + C2 - 2 sqrt(C1 C2)), with the eps-jitter fallback
when the product covariance is near-singular.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1 = np.atleast_1d(np.asarray(mu1))
    mu2 = np.atleast_1d(np.asarray(mu2))
    sigma1 = np.atleast_2d(np.asarray(sigma1))
    sigma2 = np.atleast_2d(np.asarray(sigma2))
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray):
    """(mu, sigma) of an (N, D) activation matrix."""
    features = np.asarray(features)
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    m1, s1 = activation_statistics(feats_a)
    m2, s2 = activation_statistics(feats_b)
    return calculate_frechet_distance(m1, s1, m2, s2)
