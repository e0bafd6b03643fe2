"""Fused GroupNorm(32) + swish + 3x3 same conv (+ residual add), inference only.

Replaces the TPU kernel of ``vqvae_from_gaussian_vae_tpu/ops/fused_gn_conv.py``
(``_fused_gn_swish_conv``, front door ``fused_gn_swish_conv``).  The
GroupNorm reduces to a per-(sample, channel) affine ``x * scale + shift``
(``gn_affine``, plain torch outside the kernel, as in the JAX package); the
kernel then forms ``swish(x * scale + shift)`` in float32, zero-pads it (the
padding applies after GroupNorm and swish), rounds it once to x's dtype,
convolves it with w cast to x's dtype, accumulates in float32, adds the
float32 bias and the optional residual, and rounds once.

Layout at this surface is the JAX package's: x (B, H, W, C), weight HWIO
(3, 3, C, O), residual and output (B, H, W, O).  The CUDA kernel
(``csrc/fused_gn_conv.cu``: bf16 on the Hopper implicit-GEMM body
``csrc/conv_igemm_sm90.cuh``, mode ``kIgSameGn``, whose launch
``downsample_conv.igemm_plan("same_gn", ...)`` mirrors; float32 as split
TF32 on the tensor cores over the same structure,
``csrc/conv_gn_f32_sm90.cuh``, whose launch ``gn_conv_f32_plan`` mirrors,
after a pre-pass that writes the weights' TF32 planes as
``weight_planes_plain`` does) runs for CUDA tensors; the plain version below
runs for CPU tensors and is what the kernel is held to on the card.  Like
the JAX op it has no backward: the kernel refuses inputs that want a
gradient.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

# x's dtype -> the C entry point
_ENTRIES = {torch.bfloat16: "gvq_fused_gn_conv", torch.float32: "gvq_fused_gn_conv_f32"}

# the float32 body's tiling (csrc/conv_gn_f32_sm90.cuh): an 8 x 16 pixel
# tile (the bf16 body's, kIgGnTileH x kIgGnTileW), 64 output channels a
# block, K steps of 32 input channels, four weight stages, three halo buffers
F32_TILE, F32_TILE_N, F32_TILE_K, F32_STAGES, F32_HALO_STAGES = (8, 16), 64, 32, 4, 3


@dataclass(frozen=True)
class GnConvF32Plan:
    """One launch of the float32 body on x (b, h, w, c) and O output
    channels: the spatial tiles a sample, the N tiles, the K steps, the grid
    (N tile fastest), shared memory a block, the weight scratch's floats."""
    tiles: int
    n_tiles: int
    k_steps: int
    blocks: int
    smem: int
    scratch: int


def gn_conv_f32_plan(b: int, h: int, w: int, c: int, o: int) -> GnConvF32Plan:
    """The launch ``launch_gn_conv_f32`` makes (a function of the shape)."""
    th, tw = F32_TILE
    halo = (th + 2) * (tw + 2) * 128  # a halo box: 128 bytes (32 floats) a pixel
    plane = -(-halo // 1024) * 1024
    stage = 2 * F32_TILE_N * F32_TILE_K * 4  # one tap's hi and lo planes
    smem = (F32_HALO_STAGES * 2 * plane + F32_STAGES * stage
            + 2 * (F32_STAGES + F32_HALO_STAGES) * 8 + 1024)
    tiles = -(-h // th) * -(-w // tw)
    n_tiles = -(-o // F32_TILE_N)
    return GnConvF32Plan(tiles, n_tiles, -(-c // F32_TILE_K), b * tiles * n_tiles, smem,
                         9 * 2 * o * c)


def group_stats(x, num_groups: int = 32, eps: float = 1e-6):
    """Per-(sample, channel) float32 GroupNorm (mean, rstd), each (B, C), of
    NHWC x: var = E[x^2] - mean^2, unclamped, as the JAX ops take it."""
    b, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(b, h * w, num_groups, cg)
    mean = xf.mean(dim=(1, 3))
    var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    rstd = torch.rsqrt(var + eps)
    return mean.repeat_interleave(cg, dim=1), rstd.repeat_interleave(cg, dim=1)


def gn_affine(x, gamma, beta, num_groups: int = 32, eps: float = 1e-6):
    """(scale, shift), float32 (B, C), with GN(x) * gamma + beta == x * scale + shift."""
    mean_c, rstd_c = group_stats(x, num_groups, eps)
    scale = gamma.float()[None, :] * rstd_c
    shift = beta.float()[None, :] - mean_c * scale
    return scale, shift


def fused_gn_swish_conv_plain(x, gamma, beta, w, bias, residual=None, num_groups: int = 32,
                              eps: float = 1e-6):
    """Plain version: the kernel's arithmetic step by step in PyTorch ops."""
    scale, shift = gn_affine(x, gamma, beta, num_groups, eps)
    h = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    h = (h * torch.sigmoid(h)).to(x.dtype)  # conv2d zero-pads this, the transformed input
    wt = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(h.permute(0, 3, 1, 2).float(), wt, bias.float(), padding=1).permute(0, 2, 3, 1)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype).contiguous()


def tf32_round(x):
    """float32 -> the nearest TF32 value, ties away from zero (``cvt.rna``):
    the low 13 mantissa bits cleared after adding half of their range to the
    magnitude."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def weight_planes_plain(w):
    """Plain version of the float32 body's weight pre-pass: HWIO (3, 3, C, O)
    -> (9, 2, O, C), each tap's weights transposed (K-major), plane 0 hi =
    tf32(w), plane 1 lo = tf32(w - hi)."""
    wt = w.float().reshape(9, w.shape[2], w.shape[3]).transpose(1, 2)
    hi = tf32_round(wt)
    return torch.stack((hi, tf32_round(wt - hi)), dim=1).contiguous()


def fused_gn_swish_conv_cuda(x, gamma, beta, w, bias, residual=None, num_groups: int = 32,
                             eps: float = 1e-6):
    """Launch the kernel: bf16 (C a multiple of 32, O of 8) or float32 (C
    and O multiples of 4) CUDA tensors; inference only."""
    _build.refuse_grad("fused GroupNorm + swish + conv kernel", x, gamma, beta, w, bias, residual)
    b, h, wd, c = x.shape
    o = w.shape[-1]
    if not x.is_cuda or x.dtype not in _ENTRIES:
        raise ValueError(f"fused GroupNorm + swish + conv kernel takes bf16 or float32 CUDA "
                         f"tensors, got {x.dtype} on {x.device}")
    align_c, align_o = (32, 8) if x.dtype == torch.bfloat16 else (4, 4)
    if tuple(w.shape) != (3, 3, c, o) or c % num_groups or c % align_c or o % align_o:
        raise ValueError(f"fused GroupNorm + swish + conv kernel: unsupported shapes x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)} ({x.dtype}: C % {align_c}, "
                         f"O % {align_o}, C % {num_groups} == 0)")
    if gamma.shape != (c,) or beta.shape != (c,) or bias.shape != (o,):
        raise ValueError("fused GroupNorm + swish + conv kernel: gamma, beta (C,), bias (O,)")
    if residual is not None and (residual.shape != (b, h, wd, o) or residual.dtype != x.dtype):
        raise ValueError("fused GroupNorm + swish + conv kernel: residual must be (B, H, W, O) "
                         "in x's dtype")
    if any(t.device != x.device for t in (gamma, beta, w, bias, residual) if t is not None):
        raise ValueError("fused GroupNorm + swish + conv kernel: every tensor must lie on x's "
                         "device")
    scale, shift = gn_affine(x, gamma, beta, num_groups, eps)
    return fused_gn_swish_conv_affine_cuda(x, scale, shift, w, bias, residual)


def fused_gn_swish_conv_affine_cuda(x, scale, shift, w, bias, residual=None):
    """The kernel alone, on the GroupNorm affine made beforehand (scale,
    shift: float32 (B, C), ``gn_affine``): for inputs that
    ``fused_gn_swish_conv_cuda`` takes; a launch counts on it."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    x = _build.kernel_operand(x)
    scale, shift = _build.kernel_operand(scale.float()), _build.kernel_operand(shift.float())
    wk = _build.kernel_operand(w.to(x.dtype))
    bias_f = _build.kernel_operand(bias.float())
    res = None if residual is None else _build.kernel_operand(residual)
    y = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    name = _ENTRIES[x.dtype]
    # float32: the scratch the weight pre-pass writes the TF32 planes into
    wt = (None if x.dtype == torch.bfloat16 else
          torch.empty(gn_conv_f32_plan(b, h, wd, c, o).scratch, dtype=torch.float32,
                      device=x.device))
    scratch = () if wt is None else (wt.data_ptr(),)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wk.data_ptr(), bias_f.data_ptr(),
            None if res is None else res.data_ptr(), y.data_ptr(), *scratch, b, h, wd, c, o,
            _build.stream_of(x))
    _build.check(err, name)
    fused_gn_swish_conv_cuda.launches += 1
    return y


fused_gn_swish_conv_cuda.launches = 0


def fused_gn_swish_conv(x, gamma, beta, w, bias, residual=None, num_groups: int = 32,
                        eps: float = 1e-6):
    """(B, H, W, C) -> (B, H, W, O): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_gn_swish_conv_plain(x, gamma, beta, w, bias, residual, num_groups, eps)
    return fused_gn_swish_conv_cuda(x, gamma, beta, w, bias, residual, num_groups, eps)
