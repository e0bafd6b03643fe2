"""PSNR on the 255 scale.

Port of ``vqvae_from_gaussian_vae_tpu/evaluations/psnr.py``: per-sample,
NHWC, reduced over all axes but the batch.
"""

from __future__ import annotations

import torch


def get_psnr(x_input: torch.Tensor, x_recon: torch.Tensor, zero_mean: bool = False,
             is_video: bool = False) -> torch.Tensor:
    """Per-sample PSNR; ``zero_mean``: the inputs are in [-1, 1], else [0, 1]."""
    if zero_mean:
        a = (x_input + 1.0) * 127.5
        b = (x_recon + 1.0) * 127.5
    else:
        a = x_input * 255.0
        b = x_recon * 255.0
    mse = torch.mean((a - b) ** 2, dim=tuple(range(1, a.ndim)))
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))
