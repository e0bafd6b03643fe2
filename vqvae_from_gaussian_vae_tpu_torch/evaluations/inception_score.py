"""Inception Score: exp(E_x[KL(p(y|x) || p(y))]) over class-probability rows.

A copy of ``vqvae_from_gaussian_vae_tpu/evaluations/inception_score.py``
(numpy on the host).  ``inception_score`` is the standard split IS;
``get_inception_score`` keeps the reference's function bit for bit, which
passes a 2-D array to ``scipy.stats.entropy`` with its default ``axis=0``
(each class column normalised over the samples): it equals the standard IS
only when the class marginal is uniform.
"""

from __future__ import annotations

import numpy as np


def get_inception_score(logits: np.ndarray) -> float:
    """The reference's IS: softmax over classes, then scipy's entropy along
    axis 0 (see the module docstring)."""
    logits = np.asarray(logits, dtype=np.float64)
    prob = np.exp(logits - logits.max(axis=1, keepdims=True))
    prob /= prob.sum(axis=1, keepdims=True)
    marginal = prob.mean(axis=0)
    pk = prob / prob.sum(axis=0, keepdims=True)
    qk = np.broadcast_to(marginal, prob.shape)
    qk = qk / qk.sum(axis=0, keepdims=True)
    kl_per_class = (pk * (np.log(pk) - np.log(qk))).sum(axis=0)
    return float(np.exp(kl_per_class.mean()))


def inception_score(probs: np.ndarray, splits: int = 10, eps: float = 1e-16):
    """probs: (N, classes) softmax outputs.  Returns (mean, std) over splits."""
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + eps) - np.log(marginal + eps))).sum(axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))
