"""SD3-style convolutional VAE backbone ("sd3unet").

Port of ``vqvae_from_gaussian_vae_tpu/models/unet.py``: swish, GroupNorm(32,
eps=1e-6), ResNet blocks, single-head attention at the configured
resolutions, (0,1)-padded stride-2 downsampling and nearest x2 upsampling,
``double_z`` doubling the latent channels for (mu, logvar).  Mid-block
attention is absent, as in the reference.  Parameter names are the
reference's ``pit`` state_dict names (``down.0.block.1.conv1.weight``,
GroupNorm ``weight``/``bias``, conv weights OIHW).

Layout: ``Encoder`` and ``Decoder`` take and return NHWC tensors (the JAX
package's layout); inside, activations are NCHW-shaped tensors in
channels_last memory, which is the NHWC buffer the kernels read.

Every parameter is float32, the optimizer's master copy; the convolutions
cast their weights and inputs to the compute ``dtype`` at use
(``CastConv2d``, the JAX package's ``nn.Conv(dtype=...)``), so a gradient
reaches the float32 weight through the cast.

With ``dtype`` bf16 and ``fused_*`` on, the resamples go through the fused
kernels (``ops/downsample_conv.py``, ``ops/upsample_conv.py``) exactly where
the JAX model's ``_resample_fuses`` takes its Pallas path (``train_ok``:
training too), minus the "backend is TPU" clause: the device only decides,
inside each op, between the kernel and its plain version.  So a bf16 run
walks the same fused structure on any device -- the resample emits
GroupNorm statistics that the next resblock consumes
(``group_norm_from_stats``), and a level's last resblock defers its
residual add into the resample.  When a gradient is wanted, the resamples
and the attention run their autograd Functions (training forward, then
the backward kernels), with the statistics' cotangent folded into the
resample's.

``train`` reaches every module as in the JAX model.  ``ResnetBlock`` takes
the JAX model's default-off kernels where it does: ``fused_gn_conv`` sends
both GroupNorm + swish + conv pairs through ``ops/fused_gn_conv.py`` when
not training; in bf16 training, ``GVQ_CONV_WGRAD=1`` gives the 3x3 convs the
wgrad kernel (``ops/conv3x3_train.py``) and ``GVQ_GN_BWD=1`` the GroupNorm +
swish sites the backward kernel (``ops/gn_swish_bwd.py``).  The environment
is read at forward time, as the JAX model reads it at trace time;
``GVQ_DISABLE_FUSED_KERNELS=1`` turns off the resample and training
kernels, and ``GVQ_FUSED_TRAIN=0`` the resample kernels in training.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vqvae_from_gaussian_vae_tpu_torch.models.vit import CastLinear
from vqvae_from_gaussian_vae_tpu_torch.ops.conv3x3_train import conv3x3_same_wg
from vqvae_from_gaussian_vae_tpu_torch.ops.downsample_conv import downsample_conv3x3_gn
from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import (
    kernels_disabled, sdpa_token_major)
from vqvae_from_gaussian_vae_tpu_torch.ops.fused_gn_conv import fused_gn_swish_conv
from vqvae_from_gaussian_vae_tpu_torch.ops.gn_swish_bwd import gn_swish
from vqvae_from_gaussian_vae_tpu_torch.ops.upsample_conv import upsample_nearest_conv3x3_gn
from vqvae_from_gaussian_vae_tpu_torch.utils.config import as_torch_dtype


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nonlinearity(x):
    return x * torch.sigmoid(x)  # swish


def group_norm_from_stats(x, stats, scale, bias, num_groups: int = 32, eps: float = 1e-6):
    """GroupNorm of NHWC x from precomputed (B, 2, C) float32 channel
    statistics (sum, sum of squares over H*W), as the fused resample kernels
    emit them."""
    b, h, w, c = x.shape
    cg = c // num_groups
    s = stats[:, 0].reshape(b, num_groups, cg).sum(-1)
    ss = stats[:, 1].reshape(b, num_groups, cg).sum(-1)
    n = h * w * cg
    mean = s / n
    var = torch.clamp(ss / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean = mean.repeat_interleave(cg, dim=-1)[:, None, None, :]
    inv = inv.repeat_interleave(cg, dim=-1)[:, None, None, :]
    y = (x.float() - mean) * inv
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


class CastConv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 weights, computed in ``dtype``: the input,
    weight and bias are cast at use (the JAX package's ``nn.Conv(dtype=...)``)."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = as_torch_dtype(dtype)

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """The float32 OIHW weight as an HWIO view (the JAX package's layout)."""
    return conv.weight.permute(2, 3, 1, 0)


def _resample_fuses(flag: bool, train: bool, h: int, dtype) -> bool:
    """True where Up/Downsample take the fused op (mirrors the JAX model's
    condition, ``train_ok`` set, without its TPU clause); lets a level defer
    its last resblock's residual add into the op."""
    if train and os.environ.get("GVQ_FUSED_TRAIN", "1") == "0":
        return False
    return bool(flag) and not kernels_disabled() and h % 4 == 0 and dtype == torch.bfloat16


class Normalize(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6); statistics and normalisation in float32,
    output in the input's dtype."""

    def __init__(self, in_channels: int, num_groups: int = 32):
        super().__init__(num_groups, in_channels, eps=1e-6, affine=True)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Upsample(nn.Module):
    """Nearest x2 then 3x3 conv; the fused phase-conv op on the bf16 path."""

    def __init__(self, in_channels: int, with_conv: bool = True, fused: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.with_conv = with_conv
        self.fused = fused
        self.dtype = as_torch_dtype(dtype)
        if with_conv:
            self.conv = CastConv2d(in_channels, in_channels, 3, padding=1, dtype=dtype)

    def forward(self, x, train: bool = False, with_stats: bool = False, add=None):
        use_fused = self.with_conv and _resample_fuses(self.fused, train, x.shape[2], self.dtype)
        if not use_fused:
            if add is not None:
                raise ValueError("only the fused upsample takes a deferred add")
            y = F.interpolate(x, scale_factor=2.0, mode="nearest")
            if self.with_conv:
                y = self.conv(y)
            return (y, None) if with_stats else y
        y, stats = upsample_nearest_conv3x3_gn(
            _nhwc(x), self.conv.weight.to(self.dtype).permute(2, 3, 1, 0), self.conv.bias,
            add=None if add is None else _nhwc(add))
        y = _nchw(y)
        return (y, stats) if with_stats else y


class Downsample(nn.Module):
    """(0,1) pad + stride-2 3x3 conv; the fused phase-matmul op on the bf16
    path."""

    def __init__(self, in_channels: int, with_conv: bool = True, fused: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.with_conv = with_conv
        self.fused = fused
        self.dtype = as_torch_dtype(dtype)
        if with_conv:
            self.conv = CastConv2d(in_channels, in_channels, 3, stride=2, padding=0, dtype=dtype)

    def forward(self, x, train: bool = False, with_stats: bool = False, add=None):
        use_fused = self.with_conv and _resample_fuses(self.fused, train, x.shape[2], self.dtype)
        if not use_fused:
            if add is not None:
                raise ValueError("only the fused downsample takes a deferred add")
            if self.with_conv:
                y = self.conv(F.pad(x, (0, 1, 0, 1)))
            else:
                y = F.avg_pool2d(x, 2, 2)
            return (y, None) if with_stats else y
        y, stats = downsample_conv3x3_gn(
            _nhwc(x), self.conv.weight.to(self.dtype).permute(2, 3, 1, 0), self.conv.bias,
            add=None if add is None else _nhwc(add))
        y = _nchw(y)
        return (y, stats) if with_stats else y


class ResnetBlock(nn.Module):
    """norm1 -> swish -> conv1 -> norm2 -> swish -> (dropout) -> conv2, plus
    the (shortcut-projected) input.  ``in_stats`` normalises the input from
    the producing resample's statistics; ``defer_add`` returns (x, h) for
    the consuming resample to sum.  ``fused_gn_conv`` and the training
    kernels as the JAX model's ``ResnetBlock`` (module docstring); the same
    parameters on every path."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.0,
                 fused_gn_conv: bool = False, dtype=torch.float32):
        super().__init__()
        out_ch = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out_ch
        self.dropout = dropout
        self.fused_gn_conv = fused_gn_conv
        self.dtype = as_torch_dtype(dtype)
        self.norm1 = Normalize(in_channels)
        self.conv1 = CastConv2d(in_channels, out_ch, 3, padding=1, dtype=dtype)
        self.norm2 = Normalize(out_ch)
        self.conv2 = CastConv2d(out_ch, out_ch, 3, padding=1, dtype=dtype)
        if in_channels != out_ch:
            if conv_shortcut:
                self.conv_shortcut = CastConv2d(in_channels, out_ch, 3, padding=1, dtype=dtype)
            else:
                self.nin_shortcut = CastConv2d(in_channels, out_ch, 1, dtype=dtype)

    def _gn_swish(self, norm: Normalize, x):
        return _nchw(gn_swish(_nhwc(x.to(self.dtype)), norm.weight, norm.bias))

    def _conv3(self, conv: CastConv2d, x, use_wg: bool):
        if use_wg:
            return _nchw(conv3x3_same_wg(_nhwc(x.to(self.dtype)), _hwio(conv), conv.bias))
        return conv(x)

    def forward(self, x, train: bool = False, in_stats=None, defer_add: bool = False):
        use_fused = (self.fused_gn_conv and not train and self.dropout == 0.0
                     and x.shape[2] % 8 == 0)
        use_in_stats = in_stats is not None and not use_fused
        if use_fused:
            h = fused_gn_swish_conv(_nhwc(x.to(self.dtype)), self.norm1.weight, self.norm1.bias,
                                    _hwio(self.conv1), self.conv1.bias)
            h = fused_gn_swish_conv(h, self.norm2.weight, self.norm2.bias, _hwio(self.conv2),
                                    self.conv2.bias)
            h = _nchw(h)
        else:
            env = os.environ
            bf16_train = train and self.dtype == torch.bfloat16 and not kernels_disabled()
            use_wg = bf16_train and env.get("GVQ_CONV_WGRAD", "0") == "1"
            use_gnb = bf16_train and env.get("GVQ_GN_BWD", "0") == "1"
            if use_in_stats:
                h = nonlinearity(_nchw(group_norm_from_stats(
                    _nhwc(x), in_stats, self.norm1.weight, self.norm1.bias)))
            elif use_gnb:
                h = self._gn_swish(self.norm1, x)
            else:
                h = nonlinearity(self.norm1(x))
            h = self._conv3(self.conv1, h, use_wg)
            h = self._gn_swish(self.norm2, h) if use_gnb else nonlinearity(self.norm2(h))
            if self.dropout > 0.0:
                h = F.dropout(h, self.dropout, training=train)
            h = self._conv3(self.conv2, h, use_wg)
        if self.in_channels != self.out_channels:
            if hasattr(self, "conv_shortcut"):
                x = self.conv_shortcut(x)
            else:
                x = self.nin_shortcut(x)
        if defer_add:
            return x, h
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial grid; q/k/v/proj_out are
    1x1 convs, scale c^-0.5, through ``sdpa_token_major`` (flash where its
    gate takes the grid's H*W tokens, the einsum path elsewhere)."""

    def __init__(self, in_channels: int, dtype=torch.float32):
        super().__init__()
        c = in_channels
        self.norm = Normalize(c)
        self.q = CastConv2d(c, c, 1, dtype=dtype)
        self.k = CastConv2d(c, c, 1, dtype=dtype)
        self.v = CastConv2d(c, c, 1, dtype=dtype)
        self.proj_out = CastConv2d(c, c, 1, dtype=dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        l = hh * ww
        q = _nhwc(self.q(h)).reshape(b, l, 1, c)
        k = _nhwc(self.k(h)).reshape(b, l, 1, c)
        v = _nhwc(self.v(h)).reshape(b, l, 1, c)
        o = sdpa_token_major(q, k, v, c ** -0.5).reshape(b, hh, ww, c)
        return x + self.proj_out(_nchw(o))


class LinAttnBlock(nn.Module):
    """Linear (kernel-feature) attention, single head, over the grid's H*W
    tokens: q softmaxed over channels, k over tokens, the (C, C) context
    k^T v, then q ctx through ``to_out``; ``to_qkv`` has no bias.  Plain
    torch, as the JAX model computes it in plain XLA (no kernel backs it)."""

    def __init__(self, in_channels: int, dtype=torch.float32):
        super().__init__()
        c = in_channels
        self.to_qkv = CastLinear(c, 3 * c, bias=False, dtype=dtype)
        self.to_out = CastLinear(c, c, dtype=dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        q, k, v = self.to_qkv(_nhwc(x).reshape(b, hh * ww, c)).chunk(3, dim=-1)
        q = torch.softmax(q, dim=-1)
        k = torch.softmax(k, dim=1)
        ctx = torch.einsum("bnd,bne->bde", k, v)
        out = self.to_out(torch.einsum("bnd,bde->bne", q, ctx))
        return x + _nchw(out.reshape(b, hh, ww, c))


def make_attn(in_channels: int, attn_type: str = "vanilla", dtype=torch.float32):
    if attn_type in ("vanilla", "vanilla-xformers"):
        return AttnBlock(in_channels, dtype=dtype)
    if attn_type == "none":
        return None
    if attn_type == "linear":
        return LinAttnBlock(in_channels, dtype=dtype)
    raise ValueError(f"unknown attn_type {attn_type!r}")


class _DownLevel(nn.Module):
    def __init__(self, block_specs: Sequence[Tuple[int, int]], use_attn: bool, attn_type: str,
                 dropout: float, has_downsample: bool, resamp_with_conv: bool,
                 fused_gn_conv: bool, fused_downsample: bool, dtype, remat: bool = False):
        super().__init__()
        self.use_attn = use_attn
        self.remat = remat
        self.has_downsample = has_downsample
        self.fused_downsample = fused_downsample
        self.dtype = dtype
        self.block = nn.ModuleList(
            ResnetBlock(i, o, dropout=dropout, fused_gn_conv=fused_gn_conv, dtype=dtype)
            for i, o in block_specs)
        if use_attn:
            self.attn = nn.ModuleList(make_attn(o, attn_type, dtype) for _, o in block_specs)
        if has_downsample:
            self.downsample = Downsample(block_specs[-1][1], resamp_with_conv,
                                         fused=fused_downsample, dtype=dtype)

    def forward(self, x, train: bool = False, in_stats=None):
        n = len(self.block)
        defer = (self.has_downsample and not self.use_attn
                 and _resample_fuses(self.fused_downsample, train, x.shape[2], self.dtype))
        add = None
        for i, blk in enumerate(self.block):
            stats = in_stats if i == 0 else None
            if defer and i == n - 1:
                x, add = _block(blk, self.remat, x, train, stats, True)
            else:
                x = _block(blk, self.remat, x, train, stats, False)
                if self.use_attn:
                    x = self.attn[i](x)
        out_stats = None
        if self.has_downsample:
            x, out_stats = self.downsample(x, train=train, with_stats=True, add=add)
        return x, out_stats


class _Mid(nn.Module):
    def __init__(self, channels: int, dropout: float, fused_gn_conv: bool, dtype):
        super().__init__()
        self.block_1 = ResnetBlock(channels, dropout=dropout, fused_gn_conv=fused_gn_conv,
                                   dtype=dtype)
        self.block_2 = ResnetBlock(channels, dropout=dropout, fused_gn_conv=fused_gn_conv,
                                   dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.block_2(self.block_1(x, train), train)


def _block(blk: ResnetBlock, remat: bool, x, train: bool, in_stats, defer_add: bool):
    """A level's ResnetBlock; with ``remat`` under autograd its activations
    are recomputed in the backward pass (``torch.utils.checkpoint``), as the
    JAX model wraps the levels' blocks (not the mid blocks) in ``nn.remat``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(blk, x, train, in_stats, defer_add, use_reentrant=False)
    return blk(x, train, in_stats, defer_add)


class Encoder(nn.Module):
    """(B, H, W, in_channels) -> (B, H/f, W/f, 2*z_channels or z_channels)."""

    def __init__(self, *, ch: int, out_ch: int, num_res_blocks: int,
                 attn_resolutions: Sequence[int], in_channels: int, resolution: int,
                 z_channels: int, ch_mult: Sequence[int] = (1, 2, 4, 8), dropout: float = 0.0,
                 resamp_with_conv: bool = True, double_z: bool = True,
                 use_linear_attn: bool = False, attn_type: str = "vanilla",
                 remat: bool = False, fused_gn_conv: bool = False,
                 fused_downsample: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.z_channels = z_channels
        attn_type = "linear" if use_linear_attn else attn_type
        n_res = len(ch_mult)
        self.conv_in = CastConv2d(in_channels, ch, 3, padding=1, dtype=dtype)
        in_ch_mult = (1,) + tuple(ch_mult)
        levels = []
        curr_res = resolution
        for i_level in range(n_res):
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            specs = []
            for _ in range(num_res_blocks):
                specs.append((block_in, block_out))
                block_in = block_out
            levels.append(_DownLevel(
                specs, use_attn=(curr_res in attn_resolutions) and attn_type != "none",
                attn_type=attn_type, dropout=dropout, has_downsample=i_level != n_res - 1,
                resamp_with_conv=resamp_with_conv, fused_gn_conv=fused_gn_conv,
                fused_downsample=fused_downsample, dtype=self.dtype, remat=remat))
            if i_level != n_res - 1:
                curr_res //= 2
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(ch * ch_mult[-1], dropout, fused_gn_conv, self.dtype)
        self.norm_out = Normalize(ch * ch_mult[-1])
        self.conv_out = CastConv2d(ch * ch_mult[-1], 2 * z_channels if double_z else z_channels,
                                   3, padding=1, dtype=dtype)

    def forward(self, x, train: bool = False):
        h = self.conv_in(_nchw(x).to(self.dtype))
        stats = None
        for level in self.down:
            h, stats = level(h, train=train, in_stats=stats)
        h = self.mid(h, train)
        h = nonlinearity(self.norm_out(h))
        return _nhwc(self.conv_out(h))

    @staticmethod
    def last_layer_path() -> Tuple[str, ...]:
        """The encoder's final projection: the vf adaptive weight's target."""
        return ("conv_out", "weight")


class _UpLevel(nn.Module):
    def __init__(self, block_specs: Sequence[Tuple[int, int]], use_attn: bool, attn_type: str,
                 dropout: float, has_upsample: bool, resamp_with_conv: bool,
                 fused_gn_conv: bool, fused_upsample: bool, dtype, remat: bool = False):
        super().__init__()
        self.use_attn = use_attn
        self.remat = remat
        self.has_upsample = has_upsample
        self.fused_upsample = fused_upsample
        self.dtype = dtype
        self.block = nn.ModuleList(
            ResnetBlock(i, o, dropout=dropout, fused_gn_conv=fused_gn_conv, dtype=dtype)
            for i, o in block_specs)
        if use_attn:
            self.attn = nn.ModuleList(make_attn(o, attn_type, dtype) for _, o in block_specs)
        if has_upsample:
            self.upsample = Upsample(block_specs[-1][1], resamp_with_conv,
                                     fused=fused_upsample, dtype=dtype)

    def forward(self, x, train: bool = False, in_stats=None):
        n = len(self.block)
        defer = (self.has_upsample and not self.use_attn
                 and _resample_fuses(self.fused_upsample, train, x.shape[2], self.dtype))
        add = None
        for i, blk in enumerate(self.block):
            stats = in_stats if i == 0 else None
            if defer and i == n - 1:
                x, add = _block(blk, self.remat, x, train, stats, True)
            else:
                x = _block(blk, self.remat, x, train, stats, False)
                if self.use_attn:
                    x = self.attn[i](x)
        out_stats = None
        if self.has_upsample:
            x, out_stats = self.upsample(x, train=train, with_stats=True, add=add)
        return x, out_stats


class Decoder(nn.Module):
    """(B, h, w, z_channels) -> (B, H, W, out_ch)."""

    def __init__(self, *, ch: int, out_ch: int, num_res_blocks: int,
                 attn_resolutions: Sequence[int], in_channels: int, resolution: int,
                 z_channels: int, ch_mult: Sequence[int] = (1, 2, 4, 8), dropout: float = 0.0,
                 resamp_with_conv: bool = True, give_pre_end: bool = False,
                 tanh_out: bool = False, use_linear_attn: bool = False,
                 attn_type: str = "vanilla", double_z: bool = True, remat: bool = False,
                 fused_gn_conv: bool = False, fused_upsample: bool = True,
                 dtype=torch.float32):
        super().__init__()
        del in_channels, double_z  # accepted for config aliasing with the encoder
        self.dtype = as_torch_dtype(dtype)
        self.give_pre_end = give_pre_end
        self.tanh_out = tanh_out
        attn_type = "linear" if use_linear_attn else attn_type
        n_res = len(ch_mult)
        block_in = ch * ch_mult[n_res - 1]
        curr_res = resolution // 2 ** (n_res - 1)
        self.conv_in = CastConv2d(z_channels, block_in, 3, padding=1, dtype=dtype)
        self.mid = _Mid(block_in, dropout, fused_gn_conv, self.dtype)
        levels = [None] * n_res
        for i_level in reversed(range(n_res)):
            block_out = ch * ch_mult[i_level]
            specs = []
            for _ in range(num_res_blocks + 1):
                specs.append((block_in, block_out))
                block_in = block_out
            levels[i_level] = _UpLevel(
                specs, use_attn=(curr_res in attn_resolutions) and attn_type != "none",
                attn_type=attn_type, dropout=dropout, has_upsample=i_level != 0,
                resamp_with_conv=resamp_with_conv, fused_gn_conv=fused_gn_conv,
                fused_upsample=fused_upsample, dtype=self.dtype, remat=remat)
            if i_level != 0:
                curr_res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(block_in)
        self.conv_out = CastConv2d(block_in, out_ch, 3, padding=1, dtype=dtype)

    def _trunk(self, z, train: bool):
        h = self.conv_in(_nchw(z).to(self.dtype))
        h = self.mid(h, train)
        stats = None
        for i_level in reversed(range(len(self.up))):
            h, stats = self.up[i_level](h, train=train, in_stats=stats)
        return h

    def forward(self, z, train: bool = False):
        h = self._trunk(z, train)
        if self.give_pre_end:
            return _nhwc(h)
        return self.last_layer(_nhwc(nonlinearity(self.norm_out(h))))

    def pre_last_layer(self, z, train: bool = False):
        """Everything up to (excluding) conv_out, NHWC."""
        return _nhwc(nonlinearity(self.norm_out(self._trunk(z, train))))

    def last_layer(self, h, train: bool = False):
        """conv_out (+ tanh) of ``pre_last_layer``'s NHWC output (``train``
        is accepted as the JAX model's; nothing here depends on it)."""
        del train
        h = self.conv_out(_nchw(h))
        if self.tanh_out:
            h = torch.tanh(h)
        return _nhwc(h)

    @staticmethod
    def last_layer_path() -> Tuple[str, ...]:
        """The weight the adaptive GAN weight differentiates against (the
        reference decoder's ``get_last_layer``: conv_out's weight)."""
        return ("conv_out", "weight")
