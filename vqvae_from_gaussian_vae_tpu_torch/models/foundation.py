"""Frozen foundation-model trunks for the vf alignment branch.

Port of ``vqvae_from_gaussian_vae_tpu/models/foundation.py``
(``FoundationViT``, ``aux_foundation_model``, ``DINOEncoder``): a ViT-L
layout (conv patch embedding, class token, learned positional embedding,
pre-LN blocks with optional LayerScale, a final LayerNorm) emitting the
patch-token grid (B, h, w, width) of an NHWC image in [-1, 1].

The blocks are the port's ``models/vit.py:ResidualAttentionBlock`` in
float32, so each block's two LayerNorms run the LayerNorm kernel at width
1024 on the card and its attention (L = h w + 1 = 325 at 256^2) the einsum
path, as the JAX model does.  The final ``norm`` is a plain
``nn.LayerNorm`` with eps 1e-6 and takes no kernel.  Every parameter has
``requires_grad=False``: the trunk is frozen (the JAX engine's
``stop_gradient``).  Without ``weights_path`` it runs with the engine's
seeded weights; with one, a torch state_dict of this module's keys is
loaded (``weights_only=True``) over them.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.models.vit import ResidualAttentionBlock

_SPECS = {
    # name: (patch, width, layers, heads, ls_init)
    "mae": (16, 1024, 24, 16, None),
    "dinov2": (14, 1024, 24, 16, 1e-5),
    "dinov3": (16, 1024, 24, 16, 1e-5),
}


class FoundationViT(nn.Module):
    """ViT trunk over an (image_size // patch)^2 grid."""

    def __init__(self, image_size: int, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, ls_init_value: Optional[float] = None):
        super().__init__()
        self.patch_size = patch_size
        self.width = width
        grid = image_size // patch_size
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, width))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, ls_init_value=ls_init_value)
            for _ in range(layers))
        self.norm = nn.LayerNorm(width, eps=1e-6)
        self.requires_grad_(False)

    def forward(self, x):
        b, hh, ww, _ = x.shape
        gh, gw = hh // self.patch_size, ww // self.patch_size
        x = self.patch_embed(x.float().permute(0, 3, 1, 2))  # VALID: the remainder is dropped
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1:, :].reshape(b, gh, gw, self.width)


class aux_foundation_model:
    """name -> a frozen trunk (``module``) with ``feature_dim`` and
    ``patch_size``; ``image_size`` sets the positional embedding's grid."""

    def __init__(self, name: str, weights_path: Optional[str] = None, image_size: int = 224):
        if name not in _SPECS:
            raise ValueError(f"unknown foundation model {name!r}")
        patch, width, layers, heads, ls = _SPECS[name]
        self.name = name
        self.feature_dim = width
        self.patch_size = patch
        self.weights_path = weights_path
        self.module = FoundationViT(image_size, patch, width, layers, heads, ls)

    def load_weights(self) -> None:
        """Load ``weights_path`` (a state_dict of ``module``'s keys) over the
        current weights; without one, warn that the trunk is random."""
        if not self.weights_path:
            print(f"WARNING: {self.name} foundation model running with random frozen "
                  "weights (no pretrained weights were named)", file=sys.stderr)
            return
        sd = torch.load(self.weights_path, map_location="cpu", weights_only=True)
        result = self.module.load_state_dict(sd, strict=False)
        if result.missing_keys:
            print(f"foundation model missing keys: {result.missing_keys[:5]}...",
                  file=sys.stderr)


class DINOEncoder(aux_foundation_model):
    def __init__(self, weights_path: Optional[str] = None, image_size: int = 224):
        super().__init__("dinov2", weights_path=weights_path, image_size=image_size)
