"""Binary Spherical Quantization.

Port of ``vqvae_from_gaussian_vae_tpu/quantization/bsq.py``
(``bsq_entropy_loss``, ``BSQQuantizer``).  Tokens are L2-normalised over
the channel dim (the norm clamped at 1e-12), quantized to their signs
scaled by ``q_scale`` = 1 / sqrt(embed_dim) with a straight-through
gradient, and each d-position's per-codebook sign bits pack into one index,
the first codebook most significant.  In the train branch only, the
per-bit two-way entropy loss.  ``dequant`` orders the channels
(bit, d-position), as the forward's (codebook, d-position).
"""

from __future__ import annotations

import torch

from vqvae_from_gaussian_vae_tpu_torch.quantization.common import from_tokens, to_tokens
from vqvae_from_gaussian_vae_tpu_torch.quantization.lfq import LFQQuantizer, _unpack_bits


def bsq_entropy_loss(x, embed_dim: int, temperature: float = 0.01,
                     sample_minimization_weight: float = 1.0,
                     batch_maximization_weight: float = 1.0, eps: float = 1e-5):
    """-> (sample_entropy, codebook_entropy, loss)."""
    probs = torch.sigmoid(-4.0 * x / (embed_dim**0.5) / temperature)
    probs = torch.stack([probs, 1.0 - probs], dim=-1)
    log_probs = torch.log(probs + eps)
    avg_probs = probs.reshape(-1, probs.shape[-2], probs.shape[-1]).mean(dim=0)
    avg_entropy = -torch.sum(avg_probs * torch.log(avg_probs + eps))
    sample_entropy = torch.mean(-torch.sum(probs * log_probs, dim=(-2, -1)))
    loss = sample_minimization_weight * sample_entropy - batch_maximization_weight * avg_entropy
    return sample_entropy, avg_entropy, loss


class BSQQuantizer(LFQQuantizer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.embed_dim = self.codebook_dim * self.num_codebooks

    def forward(self, z, train: bool = False, duals=None, generator=None, eps=None,
                noise_rows=None):
        zt, hw = to_tokens(z, self.format)
        b, l, c = zt.shape
        norm = torch.linalg.vector_norm(zt, dim=-1, keepdim=True)
        x = zt / torch.clamp(norm, min=1e-12)
        q_scale = 1.0 / (self.embed_dim**0.5)
        x = x.reshape(b, l, self.num_codebooks, c // self.num_codebooks)
        quantized = torch.where(x > 0, 1.0, -1.0).to(x.dtype)
        bits = ((quantized + 1.0) / 2.0).to(torch.int32)  # (b, l, nc, d)
        indices = torch.zeros_like(bits[:, :, 0, :])
        for i in range(self.num_codebooks):  # the first codebook most significant
            indices = indices * 2 + bits[:, :, i, :]
        if train:
            sample_entropy, codebook_entropy, entropy_aux_loss = bsq_entropy_loss(
                x, self.embed_dim, sample_minimization_weight=self.sample_minimization_weight,
                batch_maximization_weight=self.batch_maximization_weight)
        else:
            sample_entropy = codebook_entropy = entropy_aux_loss = torch.zeros(
                (), dtype=torch.float32, device=z.device)
        quantized = ((x + (quantized - x).detach()) * q_scale).reshape(b, l, c)
        if hw is not None:
            indices = indices.reshape(b, hw[0], hw[1], -1)
        return from_tokens(quantized, self.format, hw), {
            "indices": indices, "entropy_aux_loss": entropy_aux_loss,
            "per_sample_entropy": sample_entropy.detach(),
            "codebook_entropy": codebook_entropy.detach()}

    def dequant(self, indices):
        flat, hw = self._flat_indices(indices)
        b, l, ng = flat.shape
        nbits = self.num_codebooks  # one bit a codebook in each index
        quantized = (_unpack_bits(flat, nbits) * 2.0 - 1.0) * (1.0 / (self.embed_dim**0.5))
        # channel = bit * ng + d-position, the forward's (codebook, d) order
        quantized = quantized.transpose(2, 3).reshape(b, l, nbits * ng)
        return from_tokens(quantized, self.format, hw)
