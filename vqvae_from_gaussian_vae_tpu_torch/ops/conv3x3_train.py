"""The resblock's 3x3 same conv for training, with a hand-written weight
gradient.

Replaces the TPU kernel of ``vqvae_from_gaussian_vae_tpu/ops/conv3x3_train.py``
(``_conv3x3_wgrad``) behind its custom VJP ``conv3x3_same_wg``: the forward
conv and the input gradient stay the framework's (XLA's in the JAX package,
cuDNN's here); the weight gradient

    dw[r, s] (C, O) = sum over b, h, w of xpad[b, h + r, w + s, :]^T g[b, h, w, :]

(xpad: x with a one-pixel zero border) is the kernel, float32 and cast to
the weight's dtype; dbias is a float32 sum of g.

Layout at this surface is the JAX package's: x (B, H, W, C), weight HWIO
(3, 3, C, O), output and g (B, H, W, O).  The CUDA kernel
(``csrc/conv3x3_wgrad.cu``) runs for CUDA tensors; the plain version below
runs for CPU tensors and is what the kernel is held to on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops.downsample_conv import check_bf16_cuda, wgrad_plan


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def conv3x3_wgrad_plain(x, g):
    """Plain wgrad: dw (3, 3, C, O) float32, the shifted views of the
    zero-bordered x against g over every pixel."""
    _, h, wd, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(-1, g.shape[-1])
    taps = [xp[:, r:r + h, s:s + wd, :].reshape(-1, c).t() @ gf
            for r in range(3) for s in range(3)]
    return torch.stack(taps).reshape(3, 3, c, -1)


def conv3x3_wgrad_cuda(x, g):
    """Launch the wgrad kernels: x (B, H, W, C) and g (B, H, W, O)
    contiguous bf16 CUDA, C and O multiples of 8 -> dw (3, 3, C, O)
    float32, bit-reproducible."""
    _build.refuse_grad("conv3x3 wgrad kernel", x, g)  # no double backward
    b, h, wd, c = x.shape
    o = g.shape[-1]
    check_bf16_cuda("conv3x3 wgrad kernel", x, g)
    if tuple(g.shape) != (b, h, wd, o) or c % 8 or o % 8:
        raise ValueError(f"conv3x3 wgrad kernel: g {tuple(g.shape)} for x {tuple(x.shape)} "
                         "(C % 8 == 0, O % 8 == 0)")
    plan = wgrad_plan(9, b, h, wd, c, o)
    partial = torch.empty((plan.splits, 9, c, o), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_conv3x3_wgrad(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                                    b, h, wd, c, o, plan.splits, plan.chunk,
                                    _build.stream_of(x))
    _build.check(err, "gvq_conv3x3_wgrad")
    conv3x3_wgrad_cuda.launches += 1
    return dw


conv3x3_wgrad_cuda.launches = 0


class _Conv3x3WgFn(torch.autograd.Function):
    """The conv in x's dtype (w and bias cast to it); backward: the
    framework's input gradient, the wgrad kernel, a float32 dbias (JAX
    ``_fwd`` / ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.dtypes = (w.dtype, bias.dtype)
        y = F.conv2d(_nchw(x), wc.permute(3, 2, 0, 1), bias.to(x.dtype), padding=1)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        g = g.contiguous()
        dx = torch.ops.aten.convolution_backward(
            _nchw(g), _nchw(x), wc.permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [True, False, False])[0].permute(0, 2, 3, 1)
        wgrad = conv3x3_wgrad_plain if x.device.type == "cpu" else conv3x3_wgrad_cuda
        dw = wgrad(x.contiguous(), g)
        w_dtype, bias_dtype = ctx.dtypes
        return dx, dw.to(w_dtype), g.float().sum(dim=(0, 1, 2)).to(bias_dtype)


def conv3x3_same_wg(x, w, bias):
    """3x3 same conv (B, H, W, C) -> (B, H, W, O) + bias whose weight
    gradient is the wgrad kernel (CUDA tensors) or its plain version (CPU
    tensors)."""
    return _Conv3x3WgFn.apply(x, w, bias)
