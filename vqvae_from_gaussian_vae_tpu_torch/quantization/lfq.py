"""Lookup-Free Quantization (Open-MAGVIT2).

Port of ``vqvae_from_gaussian_vae_tpu/quantization/lfq.py``
(``lfq_entropy_loss``, ``_full_codebook``, ``LFQQuantizer``).  Each channel
is quantized to its sign in {-1, +1} with a straight-through gradient; the
bits of all channels pack into one index per latent pixel, big-endian over
the full channel dim.  In the train branch only, the entropy auxiliary loss
(sample entropy minimised, batch entropy maximised, temperature 0.01) over
the full 2^d codebook of each group and the commit loss.  ``dequant`` orders
the channels as the forward does: group-major, bit-minor.
"""

from __future__ import annotations

from math import log2

import numpy as np
import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.quantization.common import (
    ALL_FORMATS, IMAGE_FORMATS, from_tokens, to_tokens)


def lfq_entropy_loss(logits, temperature: float = 0.01, sample_minimization_weight: float = 1.0,
                     batch_maximization_weight: float = 1.0, eps: float = 1e-5):
    """-> (sample_entropy, codebook_entropy, loss)."""
    probs = torch.softmax(logits / temperature, dim=-1)
    log_probs = torch.log_softmax(logits / temperature + eps, dim=-1)
    avg_probs = probs.reshape(-1, probs.shape[-1]).mean(dim=0)
    avg_entropy = -torch.sum(avg_probs * torch.log(avg_probs + eps))
    sample_entropy = torch.mean(-torch.sum(probs * log_probs, dim=-1))
    loss = sample_minimization_weight * sample_entropy - batch_maximization_weight * avg_entropy
    return sample_entropy, avg_entropy, loss


def _full_codebook(codebook_dim: int) -> np.ndarray:
    """All 2^d sign patterns: code j's bit k (2^k) -> {-1, +1}."""
    codes = np.arange(2**codebook_dim)
    bits = (codes[:, None] & (2 ** np.arange(codebook_dim))) != 0
    return (bits * 2.0 - 1.0).astype(np.float32)


def _unpack_bits(flat, nbits: int):
    """(..., ng) int indices -> (..., ng, nbits) float32 bits, most significant first."""
    cols, rem = [None] * nbits, flat
    for i in range(nbits):
        cols[nbits - 1 - i] = torch.remainder(rem, 2).float()
        rem = torch.div(rem, 2, rounding_mode="floor")
    return torch.stack(cols, dim=-1)


class LFQQuantizer(nn.Module):
    def __init__(self, format: str, codebook_size: int, num_codebooks: int = 1,
                 sample_minimization_weight: float = 1.0, batch_maximization_weight: float = 1.0):
        super().__init__()
        if format not in ALL_FORMATS:
            raise ValueError(f"unknown format {format!r}")
        self.format = format
        self.codebook_size = codebook_size
        self.num_codebooks = num_codebooks
        self.sample_minimization_weight = sample_minimization_weight
        self.batch_maximization_weight = batch_maximization_weight
        self.codebook_dim = int(log2(codebook_size))
        self.register_buffer("codebook", torch.from_numpy(_full_codebook(self.codebook_dim)),
                             persistent=False)

    def forward(self, z, train: bool = False, duals=None, generator=None, eps=None,
                noise_rows=None):
        zt, hw = to_tokens(z, self.format)
        b, l, c = zt.shape
        x = zt.reshape(b, l, self.num_codebooks, c // self.num_codebooks)
        quantized = torch.where(x > 0, 1.0, -1.0).to(x.dtype)
        bits = ((quantized.reshape(b, l, c) + 1.0) / 2.0).to(torch.int32)
        indices = torch.zeros((b, l, 1), dtype=torch.int32, device=z.device)
        for i in range(c):  # big-endian over the full channel dim
            indices = indices * 2 + bits[:, :, i:i + 1]
        zero = torch.zeros((), dtype=torch.float32, device=z.device)
        if train:
            logits = 2.0 * torch.einsum("blcd,jd->blcj", x.float(), self.codebook)
            sample_entropy, codebook_entropy, entropy_aux_loss = lfq_entropy_loss(
                logits, sample_minimization_weight=self.sample_minimization_weight,
                batch_maximization_weight=self.batch_maximization_weight)
            commit_loss = torch.mean((x - quantized.detach()) ** 2)
        else:
            sample_entropy = codebook_entropy = entropy_aux_loss = commit_loss = zero
        quantized = (x + (quantized - x).detach()).reshape(b, l, c)  # straight through
        if hw is not None:
            indices = indices.reshape(b, hw[0], hw[1], 1)
        return from_tokens(quantized, self.format, hw), {
            "indices": indices, "entropy_aux_loss": entropy_aux_loss,
            "per_sample_entropy": sample_entropy.detach(),
            "codebook_entropy": codebook_entropy.detach(), "commit_loss": commit_loss}

    def _flat_indices(self, indices):
        if self.format in IMAGE_FORMATS:
            b, h, w, ng = indices.shape
            return indices.reshape(b, h * w, ng), (h, w)
        return indices, None

    def dequant(self, indices):
        flat, hw = self._flat_indices(indices)
        b, l, ng = flat.shape
        c = self.num_codebooks * self.codebook_dim
        quantized = _unpack_bits(flat, c) * 2.0 - 1.0  # (b, l, ng, c)
        return from_tokens(quantized.reshape(b, l, ng * c), self.format, hw)
