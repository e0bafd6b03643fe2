"""Layout helpers shared by the regularizers.

The public layout is the JAX package's: "bchw" (and its alias "bhwc") mean
a spatial latent laid out (B, H, W, C); "blc" means tokens (B, L, C).  The
format names keep the reference's YAML spelling.
"""

from __future__ import annotations

import torch

IMAGE_FORMATS = ("bchw", "bhwc")
TOKEN_FORMATS = ("blc",)
ALL_FORMATS = IMAGE_FORMATS + TOKEN_FORMATS


def to_tokens(z: torch.Tensor, fmt: str):
    """(B, H, W, C) -> (B, L, C) for image formats; identity for blc.

    Returns (tokens, hw) where hw is (H, W) or None.
    """
    if fmt in IMAGE_FORMATS:
        b, h, w, c = z.shape
        return z.reshape(b, h * w, c), (h, w)
    if fmt in TOKEN_FORMATS:
        return z, None
    raise ValueError(f"unknown format {fmt!r}")


def from_tokens(z: torch.Tensor, fmt: str, hw):
    if fmt in IMAGE_FORMATS:
        b, _, c = z.shape
        h, w = hw
        return z.reshape(b, h, w, c)
    return z
