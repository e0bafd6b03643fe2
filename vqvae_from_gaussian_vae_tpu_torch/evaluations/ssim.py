"""SSIM and MS-SSIM.

Port of ``vqvae_from_gaussian_vae_tpu/evaluations/ssim.py`` (pytorch_msssim's
conventions: an 11-tap Gaussian window of sigma 1.5 applied separably per
channel with VALID padding, K1 = 0.01, K2 = 0.03; MS-SSIM over 5 scales with
the standard weights and 2x2 average pooling between them, each scale's
term clamped at 0).  NHWC in, per-sample values out, float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable per-channel Gaussian filter, VALID padding; x NCHW."""
    c = x.shape[1]
    k = kernel.numel()
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, kernel.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_per_channel(x, y, data_range: float, win_size: int = 11, sigma: float = 1.5):
    """(ssim, cs) per sample of NCHW float32 x, y."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    kernel = torch.from_numpy(_gaussian_kernel(win_size, sigma)).to(x.device)
    mu_x, mu_y = _blur(x, kernel), _blur(y, kernel)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _blur(x * x, kernel) - mu_xx
    sigma_yy = _blur(y * y, kernel) - mu_yy
    sigma_xy = _blur(x * y, kernel) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Per-sample SSIM, NHWC."""
    return _ssim_per_channel(_nchw(x), _nchw(y), data_range)[0]


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Per-sample MS-SSIM, NHWC; needs min(H, W) > 160 for 5 scales."""
    x, y = _nchw(x), _nchw(y)
    weights = torch.tensor(_MSSSIM_WEIGHTS, device=x.device)
    values = []
    last = len(_MSSSIM_WEIGHTS) - 1
    for i in range(len(_MSSSIM_WEIGHTS)):
        s, cs = _ssim_per_channel(x, y, data_range)
        values.append(s if i == last else cs)
        if i != last:
            h, w = x.shape[2] - x.shape[2] % 2, x.shape[3] - x.shape[3] % 2
            x = F.avg_pool2d(x[:, :, :h, :w], 2)
            y = F.avg_pool2d(y[:, :, :h, :w], 2)
    values = torch.clamp(torch.stack(values), min=0.0)  # (scales, B)
    return torch.prod(values ** weights[:, None], dim=0)


def get_ssim_and_msssim(x_input: torch.Tensor, x_recon: torch.Tensor, zero_mean: bool = False,
                        is_video: bool = False):
    """(ssim, ms_ssim) per sample on the 255 scale; MS-SSIM is NaN below
    256 pixels a side, as the reference's."""
    if zero_mean:
        a = (x_input + 1.0) * 127.5
        b = (x_recon + 1.0) * 127.5
    else:
        a = x_input * 255.0
        b = x_recon * 255.0
    s = ssim(a, b)
    if x_input.shape[1] < 256 or x_input.shape[2] < 256:
        return s, torch.full_like(s, float("nan"))
    return s, ms_ssim(a, b)
