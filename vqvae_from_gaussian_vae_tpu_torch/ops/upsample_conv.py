"""Fused nearest-x2 upsample + 3x3 conv with GroupNorm statistics.

Replaces the TPU kernel ``vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py``
(``_upsample_conv_hwbc``), forward only.  Nearest x2 duplicates pixels, so
the 3x3 same conv of the upsampled image equals four 2x2 phase convs on the
low-resolution input with the tap-group kernels of ``phase_kernels``:

    y[2i+di, 2j+dj] = bias + sum_{a,b} xpad[i+di+a, j+dj+b] . k22[di,dj,a,b]

(xpad: x with a one-pixel zero halo).  An optional residual ``x + add`` is
summed first, rounded to the compute dtype; the op also returns
per-sample per-channel (sum, sum of squares) of the stored output, (B, 2, O).

Layout at this surface is the JAX package's: x (B, H, W, C), weight HWIO
(3, 3, C, O), output (B, 2H, 2W, O).  The CUDA kernel
(``csrc/upsample_conv.cu``) runs for CUDA tensors; the plain version below
runs for CPU tensors and is what the kernel is held to on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops.downsample_conv import channel_stats

_GROUPS = {0: ((0,), (1, 2)), 1: ((0, 1), (2,))}  # phase d -> tap rows of group a


def phase_kernels(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, O) HWIO -> (2, 2, 2, 2, C, O) phase kernels k22[di, dj, a, b],
    the sums of the duplicated-pixel tap groups.

    The sums are taken in float32 and rounded to w's dtype once.  (The JAX
    package sums the bf16 weight in bf16; the two agree to bf16 rounding.)
    """
    wf = w.float()
    k22 = torch.empty((2, 2, 2, 2) + tuple(w.shape[2:]), dtype=torch.float32, device=w.device)
    for di in (0, 1):
        for dj in (0, 1):
            for a in (0, 1):
                for bb in (0, 1):
                    acc = torch.zeros_like(wf[0, 0])
                    for r in _GROUPS[di][a]:
                        for s in _GROUPS[dj][bb]:
                            acc = acc + wf[r, s]
                    k22[di, dj, a, bb] = acc
    return k22.to(w.dtype)


def upsample_nearest_conv3x3_gn_plain(x, w, bias, add=None):
    """Plain version: the four phase convs in PyTorch ops, float32 math on
    operands rounded to x's dtype (k22 included), output in x's dtype."""
    if add is not None:
        x = x + add
    b, h, wd, _ = x.shape
    o = w.shape[-1]
    k22 = phase_kernels(w.to(x.dtype)).float()
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1))
    bias_f = bias.to(x.dtype).float()
    y = torch.empty((b, o, 2 * h, 2 * wd), dtype=torch.float32, device=x.device)
    for di in (0, 1):
        for dj in (0, 1):
            y[:, :, di::2, dj::2] = F.conv2d(
                xp[:, :, di:di + h + 1, dj:dj + wd + 1],
                k22[di, dj].permute(3, 2, 0, 1), bias_f)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    return y, channel_stats(y)


def upsample_nearest_conv3x3_gn_cuda(x, w, bias, add=None):
    """Launch the kernel: bf16 CUDA tensors, C a multiple of 32, O a multiple
    of 128.  k22 is computed here, once per call, not per block."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"upsample kernel takes bf16 CUDA tensors, got {x.dtype} on {x.device}")
    if tuple(w.shape) != (3, 3, c, o) or c % 32 or o % 128:
        raise ValueError(f"upsample kernel: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if add is not None and (add.shape != x.shape or add.dtype != x.dtype
                            or add.device != x.device):
        raise ValueError("upsample kernel: add must match x")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("upsample kernel: weight and bias must lie on x's device")
    x = x.contiguous()
    add = None if add is None else add.contiguous()
    k22 = phase_kernels(w.to(torch.bfloat16)).contiguous()
    bias_f = bias.to(torch.bfloat16).float().contiguous()
    n_mt = -(-(h * wd) // 128)
    y = torch.empty((b, 2 * h, 2 * wd, o), dtype=x.dtype, device=x.device)
    partial = torch.empty((b, 4 * n_mt, 2, o), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, o), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_upsample_conv(
            x.data_ptr(), None if add is None else add.data_ptr(), k22.data_ptr(),
            bias_f.data_ptr(), y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            b, h, wd, c, o, _build.stream_of(x))
    _build.check(err, "gvq_upsample_conv")
    upsample_nearest_conv3x3_gn_cuda.launches += 1
    return y, stats


upsample_nearest_conv3x3_gn_cuda.launches = 0


def upsample_nearest_conv3x3_gn(x, w, bias, add=None):
    """(B,H,W,C) -> ((B,2H,2W,O), (B,2,O) float32 stats): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return upsample_nearest_conv3x3_gn_plain(x, w, bias, add)
    return upsample_nearest_conv3x3_gn_cuda(x, w, bias, add)
