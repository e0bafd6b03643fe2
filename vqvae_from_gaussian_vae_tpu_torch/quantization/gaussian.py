"""Gaussian-quantization regularizer, eval branch: the paper's VQ step.

Port of ``vqvae_from_gaussian_vae_tpu/quantization/gaussian.py``
(``GaussianQuantRegularizer``): the encoder's (mu, logvar) posterior is
turned into token indices by a nearest-sample search over the fixed 2^16
Gaussian codebook (``ops/gq_search.py``), and ``dequant`` maps indices back
to latents.  Only inference is ported; ``train=True`` raises.

Channel grouping is the reference's: c -> (group, c // group) row-major, so
each of the ng = c // group index groups gathers the strided channels
{j, ng + j, 2 ng + j, ...}.

The eval branch also returns ``zhat_noquant = mu + eps * std``; eps comes
from the caller's ``torch.Generator`` or is injected (``eps=``), since
torch cannot replay ``jax.random``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.ops import codebook as codebook_ops
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import (
    KERNEL_BACKENDS, PLAIN_BACKENDS, gq_search)
from vqvae_from_gaussian_vae_tpu_torch.quantization.common import (
    ALL_FORMATS, IMAGE_FORMATS, from_tokens, to_tokens)


def _split_posterior(z: torch.Tensor, logvar_range) -> Tuple[torch.Tensor, ...]:
    """z (..., 2C) -> mu, logvar (clamped), std, all float32."""
    mu, logvar = torch.chunk(z.float(), 2, dim=-1)
    logvar = torch.clamp(logvar, logvar_range[0], logvar_range[1])
    std = torch.exp(0.5 * logvar)
    return mu, logvar, std


class GaussianQuantRegularizer(nn.Module):
    """Per-group GQ regularizer; the codebook is a non-persistent buffer
    (checkpoints do not carry it)."""

    def __init__(self, format: str, n_samples: int, group: int = 1,
                 logvar_range: Tuple[float, float] = (-30.0, 20.0), tolerance: float = 0.5,
                 lam_factor: float = 1.01, seed: int = 42, beta: float = 1.0,
                 backend: str = "auto"):
        super().__init__()
        if format not in ALL_FORMATS:
            raise ValueError(f"unknown format {format!r}")
        if backend not in KERNEL_BACKENDS + PLAIN_BACKENDS:
            raise ValueError(f"unknown gq_search backend {backend!r}")
        self.format = format
        self.n_samples = n_samples
        self.group = group
        self.logvar_range = tuple(logvar_range)
        self.tolerance = tolerance    # train-branch knobs, kept for config parity
        self.lam_factor = lam_factor
        self.beta = beta
        self.backend = backend
        self.log_n_samples = int(math.log(n_samples, 2))
        table = codebook_ops.prior_samples(n_samples, group, seed)
        self.register_buffer("codebook", torch.from_numpy(table.copy()), persistent=False)

    def rows(self, mu: torch.Tensor) -> torch.Tensor:
        """(B, L, C) -> (B*L*ng, group) with the strided grouping."""
        b, l, c = mu.shape
        ng = c // self.group
        return mu.reshape(b, l, self.group, ng).transpose(2, 3).reshape(-1, self.group)

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        if train:
            raise NotImplementedError("the GQ train branch is not ported yet")
        zt, hw = to_tokens(z, self.format)
        b, l, c2 = zt.shape
        c = c2 // 2
        ng = c // self.group
        mu, _, std = _split_posterior(zt, self.logvar_range)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                              dtype=torch.float32)
        zhat_noquant = mu + eps.reshape(mu.shape).to(mu) * std
        indices = gq_search(self.rows(mu), self.rows(std), self.codebook, beta=self.beta,
                            backend=self.backend)
        zhat = self.codebook[indices.long()]
        zhat = zhat.reshape(b, l, ng, self.group).transpose(2, 3).reshape(b, l, c)
        indices = indices.reshape(b, l, ng)
        zhat = from_tokens(zhat, self.format, hw)
        zhat_noquant = from_tokens(zhat_noquant, self.format, hw)
        if hw is not None:
            indices = indices.reshape(b, hw[0], hw[1], ng)
        return zhat, {"indices": indices, "zhat_noquant": zhat_noquant}

    def dequant(self, indices: torch.Tensor) -> torch.Tensor:
        """indices -> zhat via codebook lookup and group interleave."""
        if self.format in IMAGE_FORMATS:
            b, h, w, ng = indices.shape
            l, hw = h * w, (h, w)
        else:
            b, l, ng = indices.shape
            hw = None
        zhat = self.codebook[indices.reshape(-1).long()]
        zhat = zhat.reshape(b, l, ng, self.group).transpose(2, 3).reshape(b, l, ng * self.group)
        return from_tokens(zhat, self.format, hw)
