"""Classic VQ-VAE quantizer: the L2-nearest entry of a learned codebook.

Port of ``vqvae_from_gaussian_vae_tpu/quantization/vq.py`` (``VQQuantizer``).
The channel axis is split c -> (dim, codebook_num) row-major, so
sub-codebook i takes the strided channels {i, codebook_num + i, ...};
every sub-codebook shares the one table ``embedding`` (an ``nn.Embedding``,
state_dict key ``regularization.embedding.weight``).  ``legacy`` keeps the
reference's swapped beta placement; the output is the straight-through
code (its value the code itself) and ``codebook_loss`` trains the table
and the encoder.

The search (``ops/gq_search.py:vq_search``) runs the GQ search kernel for
CUDA tensors: argmin_n |z - e_n|^2 is argmax_n of [2z, -1] . [e_n; e_n^2],
the GQ score at std 1 and beta 0.  For CPU tensors it runs the JAX
package's formula, |z|^2 + |e|^2 - 2 z . e in float32, then argmin.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import vq_search
from vqvae_from_gaussian_vae_tpu_torch.quantization.common import (
    ALL_FORMATS, IMAGE_FORMATS, from_tokens, to_tokens)


class VQQuantizer(nn.Module):
    def __init__(self, format: str, n: int, dim: int, beta: float = 0.25,
                 codebook_num: int = 1, legacy: bool = True):
        super().__init__()
        if format not in ALL_FORMATS:
            raise ValueError(f"unknown format {format!r}")
        self.format = format
        self.n = n
        self.dim = dim
        self.beta = beta
        self.codebook_num = codebook_num
        self.legacy = legacy
        self.embedding = nn.Embedding(n, dim)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """uniform(-1/n, 1/n), the reference's init."""
        nn.init.uniform_(self.embedding.weight, -1.0 / self.n, 1.0 / self.n)

    def forward(self, z, train: bool = False, duals=None, generator=None, eps=None,
                noise_rows=None):
        zt, hw = to_tokens(z, self.format)
        b, l, c = zt.shape
        cn = self.codebook_num
        if self.dim * cn != c:
            raise ValueError(f"VQQuantizer: {c} channels != dim {self.dim} x {cn} codebooks")
        zf = zt.reshape(-1, self.dim, cn)
        e = self.embedding.weight
        rows = zf.detach().transpose(1, 2).reshape(-1, self.dim)  # (B*L*cn, dim)
        idx = vq_search(rows, e.detach()).reshape(-1, cn).long()
        zq = e[idx].transpose(1, 2)  # (B*L, dim, cn)
        zf_img, zq_img = zf.reshape(zt.shape), zq.reshape(zt.shape)
        commit = torch.mean((zq_img.detach() - zf_img) ** 2)
        codebook = torch.mean((zq_img - zf_img.detach()) ** 2)
        loss = commit + self.beta * codebook if self.legacy else self.beta * commit + codebook
        # straight through: the value is the code itself (so dequant(indices)
        # gives the same latent bit for bit), the gradient the identity to
        # z; JAX's zf + sg(zq - zf) up to one float32 rounding
        zq_img = zq_img.detach() + (zf_img - zf_img.detach())
        indices = idx.to(torch.int32).reshape(b, l, cn)
        if hw is not None:
            indices = indices.reshape(b, hw[0], hw[1], cn)
        return from_tokens(zq_img, self.format, hw), {"indices": indices, "codebook_loss": loss}

    def dequant(self, indices):
        if self.format in IMAGE_FORMATS:
            b, h, w, cn = indices.shape
            hw, l = (h, w), h * w
        else:
            b, l, cn = indices.shape
            hw = None
        zq = self.embedding.weight[indices.reshape(-1, cn).long()]  # (B*L, cn, dim)
        zq = zq.transpose(1, 2).reshape(b, l, self.dim * cn)
        return from_tokens(zq, self.format, hw)
