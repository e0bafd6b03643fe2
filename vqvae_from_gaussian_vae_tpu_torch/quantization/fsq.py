"""Finite Scalar Quantization (arXiv 2309.15505, appendix A.1).

Port of ``vqvae_from_gaussian_vae_tpu/quantization/fsq.py``
(``FSQQuantizer``).  Each channel is bounded by tanh (with the atanh
offset shift for an even level count), rounded half to even with a
straight-through gradient and scaled to [-1, 1]; the channels' digits pack
into one index per latent pixel, mixed radix, the first level most
significant.  z is cast to float32 first, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.quantization.common import (
    ALL_FORMATS, IMAGE_FORMATS, from_tokens, round_ste, to_tokens)


class FSQQuantizer(nn.Module):
    def __init__(self, levels: Sequence[int], format: str):
        super().__init__()
        if format not in ALL_FORMATS:
            raise ValueError(f"unknown format {format!r}")
        self.levels = [int(v) for v in levels]
        self.format = format
        self.dim = len(self.levels)

    def _level_tensors(self, device):
        levels = torch.tensor(self.levels, dtype=torch.float32, device=device)
        odd = torch.tensor([v % 2 for v in self.levels], device=device) == 1
        half_width = torch.tensor([v // 2 for v in self.levels], dtype=torch.float32,
                                  device=device)
        return levels, odd, half_width

    def _quantize(self, zhat, eps: float = 1e-3):
        """tanh bound and round -> (zq in [-1, 1], per-channel digits)."""
        levels, odd, half_width = self._level_tensors(zhat.device)
        half_l = (levels - 1.0) * (1.0 + eps) / 2.0
        offset = torch.where(odd, 0.0, 0.5)
        shift = torch.atanh(offset / half_l)
        bounded = torch.tanh(zhat + shift) * half_l - offset
        rounded = round_ste(bounded)
        return rounded / half_width, (rounded + half_width).to(torch.int32)

    def _pack(self, digits):
        """(..., dim) digits -> (..., 1) mixed-radix index, first level most significant."""
        indices = torch.zeros_like(digits[..., 0:1])
        for li, level in enumerate(self.levels):
            indices = indices * level + digits[..., li:li + 1]
        return indices

    def forward(self, z, train: bool = False, duals=None, generator=None, eps=None,
                noise_rows=None):
        zt, hw = to_tokens(z.float(), self.format)
        ndim = zt.shape[1] * zt.shape[2] if hw is None else math.prod(z.shape[1:])
        zq, digits = self._quantize(zt)
        indices = self._pack(digits)
        bits = float(sum(math.log2(v) for v in self.levels)) * ndim
        if hw is not None:
            indices = indices.reshape(indices.shape[0], hw[0], hw[1], 1)
        return from_tokens(zq, self.format, hw), {
            "indices": indices,
            "bits": torch.tensor(bits, dtype=torch.float32, device=z.device)}

    def dequant(self, indices):
        if self.format in IMAGE_FORMATS:
            b, h, w, _ = indices.shape
            hw, flat = (h, w), indices.reshape(b, h * w, 1)
        else:
            hw, flat = None, indices
        digits, rem = [], flat
        for level in reversed(self.levels):
            digits.append(torch.remainder(rem, level))
            rem = torch.div(rem, level, rounding_mode="floor")
        per_level = torch.cat(digits[::-1], dim=2).float()
        _, _, half_width = self._level_tensors(indices.device)
        return from_tokens((per_level - half_width) / half_width, self.format, hw)

    def generate(self, generator: Optional[torch.Generator], shape):
        """Uniform codes, decoded: ``shape`` is (B, H, W, C) for the image
        formats, (B, L, C) for blc; one draw of each level's digits from
        ``generator`` (on its device; the CPU's default without one), first
        level first."""
        if self.format in IMAGE_FORMATS:
            bl = (shape[0], shape[1] * shape[2], 1)
        else:
            bl = (shape[0], shape[1], 1)
        device = generator.device if generator is not None else "cpu"
        digits = torch.cat([torch.randint(0, level, bl, generator=generator, device=device,
                                          dtype=torch.int32) for level in self.levels], dim=2)
        indices = self._pack(digits)
        if self.format in IMAGE_FORMATS:
            indices = indices.reshape(shape[0], shape[1], shape[2], 1)
        return self.dequant(indices)
