"""Fused stride-2 3x3 downsample conv with GroupNorm statistics.

Replaces the TPU kernel ``vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py``
(``_downsample_conv``), forward only.  The op: (0,1) zero pad (one row at
the bottom, one column at the right), stride-2 3x3 conv, bias, with an
optional residual ``x + add`` summed first (rounded to the compute dtype),
and per-sample per-channel (sum, sum of squares) of the output as stored in
the compute dtype, shaped (B, 2, O), for the consumer's GroupNorm.

Layout at this surface is the JAX package's: x and add (B, H, W, C), weight
HWIO (3, 3, C, O), output (B, H/2, W/2, O).  The CUDA kernel
(``csrc/downsample_conv.cu``) runs for CUDA tensors; the plain version below
runs for CPU tensors and is what the kernel is held to on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.ops import _build


def channel_stats(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2, C) float32 (sum, sum of squares) over H, W."""
    yf = y.float()
    return torch.stack([yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))], dim=1)


def downsample_conv3x3_gn_plain(x, w, bias, add=None):
    """Plain version: the same function in PyTorch ops, float32 math on
    operands rounded to x's dtype, output rounded to x's dtype."""
    if add is not None:
        x = x + add
    xin = F.pad(x.permute(0, 3, 1, 2).float(), (0, 1, 0, 1))
    wt = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xin, wt, bias.to(x.dtype).float(), stride=2)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    return y, channel_stats(y)


def downsample_conv3x3_gn_cuda(x, w, bias, add=None):
    """Launch the kernel: bf16 CUDA tensors, C a multiple of 32, O a multiple
    of 128, even H and W."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"downsample kernel takes bf16 CUDA tensors, got {x.dtype} on {x.device}")
    if tuple(w.shape) != (3, 3, c, o) or c % 32 or o % 128 or h % 2 or wd % 2:
        raise ValueError(f"downsample kernel: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if add is not None and (add.shape != x.shape or add.dtype != x.dtype
                            or add.device != x.device):
        raise ValueError("downsample kernel: add must match x")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("downsample kernel: weight and bias must lie on x's device")
    x = x.contiguous()
    add = None if add is None else add.contiguous()
    w = w.to(torch.bfloat16).contiguous()
    bias_f = bias.to(torch.bfloat16).float().contiguous()
    ho, wo = h // 2, wd // 2
    n_mt = -(-(ho * wo) // 128)
    y = torch.empty((b, ho, wo, o), dtype=x.dtype, device=x.device)
    partial = torch.empty((b, n_mt, 2, o), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, o), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_downsample_conv(
            x.data_ptr(), None if add is None else add.data_ptr(), w.data_ptr(),
            bias_f.data_ptr(), y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            b, h, wd, c, o, _build.stream_of(x))
    _build.check(err, "gvq_downsample_conv")
    downsample_conv3x3_gn_cuda.launches += 1
    return y, stats


downsample_conv3x3_gn_cuda.launches = 0


def downsample_conv3x3_gn(x, w, bias, add=None):
    """(B,H,W,C) -> ((B,H/2,W/2,O), (B,2,O) float32 stats): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return downsample_conv3x3_gn_plain(x, w, bias, add)
    return downsample_conv3x3_gn_cuda(x, w, bias, add)
