"""The WAN causal-3D video VAE (Wan2.1 / Qwen-Image), float32.

Port of ``vqvae_from_gaussian_vae_tpu/models/wan.py``: causal 3-D convs (the
time axis padded in front only, with zeros), channel-L2 RMS norms
(``x / max(||x||, 1e-12) * sqrt(dim) * gamma``), SiLU, per-frame
single-head spatial attention (softmax in float32), the WAN resamples
(spatial: a (0, 1)-padded stride-2 3x3 conv down, nearest x2 then a 3x3 conv
to ``dim // 2`` up; temporal, in the ``*3d`` modes: a stride-2 (3, 1, 1)
conv down, a channel-doubling (3, 1, 1) conv up whose halves interleave as
even and odd frames) and a diagonal-Gaussian latent.  The JAX package
computes all of it in plain XLA (no ``pallas_call``), so the convs are
``nn.Conv3d`` / ``nn.Conv2d`` (cuDNN on the card) and the attention is
``torch.matmul`` and softmax.

Inside, tensors are NCTHW.  ``AutoencoderKLWan``'s interface is the JAX
package's channel-last one: clips (B, T, H, W, 3) in [-1, 1], latents
(B, T', H/8, W/8, z).  Two paths run the same weights:

  * ``encode`` / ``decode``: the whole clip at once (the temporal branches
    only where T > 1; the whole-clip temporal downsample pads one frame);
  * ``encode_chunked`` / ``decode_chunked``: diffusers' streaming, exact
    frame for frame -- the first frame alone, then 4-frame chunks (one
    latent frame a chunk on decode) through a feature cache: each causal
    conv pads its front from the previous chunk's last two input frames,
    a temporal downsample only fills its cache on the first chunk, a
    temporal upsample marks it ("Rep") and pads two zero frames on the next.

For one frame the two paths are the same computation.  Module and
parameter names are the diffusers ``AutoencoderKLWan`` tree
(``encoder.down_blocks.2.resample.1.weight``, ``decoder.up_blocks.0.
upsamplers.0.time_conv.weight``, ``encoder.mid_block.attentions.0.to_qkv``),
so the JAX package's ``convert_state_dict`` reads this module's
``state_dict``; the RMS norms' ``gamma`` is (C,) here, where diffusers keeps
(C, 1, 1, 1), and ``load_checkpoint`` reshapes it.  The module lives on the
CUDA device unless the caller passes ``device="cpu"``; its weights are
seeded.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import init_weights, resolve_device
from vqvae_from_gaussian_vae_tpu_torch.models.hyvae import DiagonalGaussianDistribution

_CACHE_T = 2  # the frames of a causal conv's input that the next chunk pads from


def _pad_time(x: torch.Tensor, front: int) -> torch.Tensor:
    """Zero frames in front of an NCTHW tensor's time axis."""
    return F.pad(x, (0, 0, 0, 0, front, 0)) if front > 0 else x


class CausalConv3d(nn.Conv3d):
    """Conv3d with ``time_pad`` zero frames in front (``kt - 1`` unless
    given) and same spatial padding.  With a feature cache (``cache``, a dict
    the chunk loop keeps, and ``idx``, a one-item list of this conv's slot)
    the front is padded from the previous chunk's last frames instead."""

    def __init__(self, in_dim: int, out_dim: int, kernel: Tuple[int, int, int] = (3, 3, 3),
                 stride: Tuple[int, int, int] = (1, 1, 1), time_pad: Optional[int] = None):
        super().__init__(in_dim, out_dim, kernel, stride,
                         padding=(0, kernel[1] // 2, kernel[2] // 2))
        self.time_pad = kernel[0] - 1 if time_pad is None else time_pad

    def valid(self, x: torch.Tensor) -> torch.Tensor:
        """The conv with no time padding."""
        return super().forward(x)

    def forward(self, x, cache=None, idx=None):
        if cache is None:
            return self.valid(_pad_time(x, self.time_pad))
        i = idx[0]
        tp = 2 * (self.kernel_size[0] // 2)
        cur = cache.get(i)
        cx = x[:, :, -_CACHE_T:]
        if cx.shape[2] < _CACHE_T and cur is not None:
            cx = torch.cat([cur[:, :, -1:], cx], dim=2)
        xin, pad = x, tp
        if cur is not None and tp > 0:
            xin = torch.cat([cur, x], dim=2)
            pad = tp - cur.shape[2]
        cache[i] = cx.clone()
        idx[0] += 1
        return self.valid(_pad_time(xin, pad))


class WanRMSNorm(nn.Module):
    """L2 norm over channels (axis 1) in float32, clamped at 1e-12, times
    ``sqrt(dim) * gamma``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x.float(), dim=1, keepdim=True)
        n = x / torch.clamp(norm, min=1e-12)
        gamma = self.gamma.reshape((-1,) + (1,) * (x.dim() - 2))
        return (n * self.dim ** 0.5 * gamma).to(x.dtype)


class WanResidualBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.0):
        super().__init__()
        self.norm1 = WanRMSNorm(in_dim)
        self.conv1 = CausalConv3d(in_dim, out_dim)
        self.norm2 = WanRMSNorm(out_dim)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = CausalConv3d(out_dim, out_dim)
        self.conv_shortcut = (CausalConv3d(in_dim, out_dim, (1, 1, 1))
                              if in_dim != out_dim else None)

    def forward(self, x, cache=None, idx=None):
        h = self.conv1(F.silu(self.norm1(x)), cache, idx)
        h = self.conv2(self.dropout(F.silu(self.norm2(h))), cache, idx)
        if self.conv_shortcut is not None:  # a 1x1x1 conv: no cache slot
            x = self.conv_shortcut(x)
        return x + h


class WanAttentionBlock(nn.Module):
    """Per-frame single-head spatial self-attention, 1x1-conv q, k, v and
    output projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = WanRMSNorm(dim)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.norm(x).transpose(1, 2).reshape(b * t, c, h, w)
        q, k, v = self.to_qkv(y).reshape(b * t, 3 * c, h * w).chunk(3, dim=1)
        attn = torch.matmul(q.transpose(1, 2), k).float() * c ** -0.5  # (bt, q, k)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        y = torch.matmul(v, attn.transpose(1, 2)).reshape(b * t, c, h, w)
        y = self.proj(y)
        return x + y.reshape(b, t, c, h, w).transpose(1, 2)


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B * T, C, H, W)."""
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


def _clip(y: torch.Tensor, b: int) -> torch.Tensor:
    """(B * T, C, H, W) -> (B, C, T, H, W)."""
    return y.reshape(b, -1, *y.shape[1:]).transpose(1, 2)


def _interleave(tc: torch.Tensor) -> torch.Tensor:
    """A channel-doubling conv's (B, 2C, T, H, W) output as (B, C, 2T, H,
    W): frame 2i + d is channel half d of frame i."""
    b, c2, t, h, w = tc.shape
    tc = tc.reshape(b, 2, c2 // 2, t, h, w)
    return torch.stack((tc[:, 0], tc[:, 1]), dim=3).reshape(b, c2 // 2, 2 * t, h, w)


class WanResample(nn.Module):
    """'upsample2d' | 'upsample3d' | 'downsample2d' | 'downsample3d'
    (``resample.1`` the spatial conv, ``time_conv`` the temporal one)."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        if mode not in ("upsample2d", "upsample3d", "downsample2d", "downsample3d"):
            raise ValueError(f"WanResample mode {mode!r}")
        self.mode = mode
        if mode.startswith("upsample"):
            self.resample = nn.Sequential(nn.Upsample(scale_factor=2.0, mode="nearest"),
                                          nn.Conv2d(dim, dim // 2, 3, padding=1))
            if mode == "upsample3d":
                self.time_conv = CausalConv3d(dim, 2 * dim, (3, 1, 1))
        else:
            self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)),
                                          nn.Conv2d(dim, dim, 3, stride=2))
            if mode == "downsample3d":
                self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), (2, 1, 1), time_pad=1)

    def forward(self, x, cache=None, idx=None):
        b = x.shape[0]
        if self.mode == "upsample3d":
            if cache is None:
                if x.shape[2] > 1:
                    x = _interleave(self.time_conv(x))
            else:
                x = self._cached_time_up(x, cache, idx)
        if self.mode.startswith("upsample"):
            return _clip(self.resample(_frames(x)), b)
        x = _clip(self.resample(_frames(x)), b)
        if self.mode == "downsample3d":
            if cache is None:
                if x.shape[2] > 1:
                    x = self.time_conv(x)
            else:
                x = self._cached_time_down(x, cache, idx)
        return x

    def _cached_time_up(self, x, cache, idx):
        i = idx[0]
        cur = cache.get(i)
        idx[0] += 1
        if cur is None:  # the first chunk: no temporal conv, the slot marked
            cache[i] = "Rep"
            return x
        cx = x[:, :, -_CACHE_T:]
        if isinstance(cur, str):  # the first real chunk: a zero history
            xin = _pad_time(x, 2)
        else:
            if cx.shape[2] < _CACHE_T:
                cx = torch.cat([cur[:, :, -1:], cx], dim=2)
            xin = _pad_time(torch.cat([cur, x], dim=2), 2 - cur.shape[2])
        cache[i] = cx.clone()
        return _interleave(self.time_conv.valid(xin))

    def _cached_time_down(self, x, cache, idx):
        i = idx[0]
        cur = cache.get(i)
        idx[0] += 1
        if cur is None:  # the first chunk only fills the cache
            cache[i] = x.clone()
            return x
        cache[i] = x[:, :, -1:].clone()
        return self.time_conv.valid(torch.cat([cur[:, :, -1:], x], dim=2))


class WanMidBlock(nn.Module):
    def __init__(self, dim: int, dropout: float = 0.0):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(dim, dim, dropout),
                                      WanResidualBlock(dim, dim, dropout)])
        self.attentions = nn.ModuleList([WanAttentionBlock(dim)])

    def forward(self, x, cache=None, idx=None):
        x = self.resnets[0](x, cache, idx)
        x = self.attentions[0](x)
        return self.resnets[1](x, cache, idx)


class WanEncoder3d(nn.Module):
    """(B, 3, T, H, W) -> (B, 2 z, T', H / 8, W / 8) moments."""

    def __init__(self, base_dim: int = 96, z_dim: int = 16,
                 dim_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_scales: Sequence[float] = (),
                 temperal_downsample: Sequence[bool] = (False, True, True),
                 dropout: float = 0.0):
        super().__init__()
        dims = [base_dim * u for u in (1,) + tuple(dim_mult)]
        self.conv_in = CausalConv3d(3, dims[0])
        self.down_blocks = nn.ModuleList()
        scale = 1.0
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(num_res_blocks):
                self.down_blocks.append(WanResidualBlock(in_dim, out_dim, dropout))
                if scale in attn_scales:
                    self.down_blocks.append(WanAttentionBlock(out_dim))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                mode = "downsample3d" if temperal_downsample[i] else "downsample2d"
                self.down_blocks.append(WanResample(out_dim, mode))
                scale /= 2.0
        self.mid_block = WanMidBlock(dims[-1], dropout)
        self.norm_out = WanRMSNorm(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], 2 * z_dim)

    def forward(self, x, cache=None, idx=None):
        x = self.conv_in(x, cache, idx)
        for blk in self.down_blocks:
            x = blk(x) if isinstance(blk, WanAttentionBlock) else blk(x, cache, idx)
        x = self.mid_block(x, cache, idx)
        return self.conv_out(F.silu(self.norm_out(x)), cache, idx)


class WanUpBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_resnets: int,
                 upsample_mode: Optional[str], dropout: float = 0.0):
        super().__init__()
        self.resnets = nn.ModuleList()
        for _ in range(num_resnets):
            self.resnets.append(WanResidualBlock(in_dim, out_dim, dropout))
            in_dim = out_dim
        self.upsamplers = (nn.ModuleList([WanResample(out_dim, upsample_mode)])
                           if upsample_mode is not None else None)

    def forward(self, x, cache=None, idx=None):
        for resnet in self.resnets:
            x = resnet(x, cache, idx)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, cache, idx)
        return x


class WanDecoder3d(nn.Module):
    """(B, z, T', h, w) -> (B, 3, T, 8 h, 8 w)."""

    def __init__(self, base_dim: int = 96, z_dim: int = 16,
                 dim_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_scales: Sequence[float] = (),
                 temperal_upsample: Sequence[bool] = (True, True, False),
                 dropout: float = 0.0):
        super().__init__()
        del attn_scales  # the decoder has attention in its mid block only
        dims = [base_dim * u for u in (dim_mult[-1],) + tuple(reversed(dim_mult))]
        self.conv_in = CausalConv3d(z_dim, dims[0])
        self.mid_block = WanMidBlock(dims[0], dropout)
        self.up_blocks = nn.ModuleList()
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0:
                in_dim = in_dim // 2  # the previous stage's upsample halved the channels
            mode = None
            if i != len(dim_mult) - 1:
                mode = "upsample3d" if temperal_upsample[i] else "upsample2d"
            self.up_blocks.append(WanUpBlock(in_dim, out_dim, num_res_blocks + 1, mode,
                                             dropout))
        self.norm_out = WanRMSNorm(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], 3)

    def forward(self, z, cache=None, idx=None):
        x = self.conv_in(z, cache, idx)
        x = self.mid_block(x, cache, idx)
        for blk in self.up_blocks:
            x = blk(x, cache, idx)
        return self.conv_out(F.silu(self.norm_out(x)), cache, idx)


def _ncthw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _nthwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class AutoencoderKLWan(nn.Module):
    """The WAN VAE with the diffusers layout (``encoder``, ``quant_conv``,
    ``post_quant_conv``, ``decoder``): ``encode`` -> the channel-last
    diagonal-Gaussian posterior over ``z_dim`` channels, ``decode`` -> a
    clip clamped to [-1, 1].  The defaults are the published Wan2.1 /
    Qwen-Image VAE's.  ``latents_mean`` / ``latents_std`` are carried as
    config, as diffusers does: encode and decode work on raw latents."""

    def __init__(self, base_dim: int = 96, z_dim: int = 16,
                 dim_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_scales: Sequence[float] = (),
                 temperal_downsample: Sequence[bool] = (False, True, True),
                 latents_mean: Optional[Sequence[float]] = None,
                 latents_std: Optional[Sequence[float]] = None,
                 seed: int = 0, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.z_dim = z_dim
        self.latents_mean = latents_mean
        self.latents_std = latents_std
        common = dict(base_dim=base_dim, z_dim=z_dim, dim_mult=tuple(dim_mult),
                      num_res_blocks=num_res_blocks, attn_scales=tuple(attn_scales))
        self.encoder = WanEncoder3d(temperal_downsample=tuple(temperal_downsample), **common)
        self.quant_conv = CausalConv3d(2 * z_dim, 2 * z_dim, (1, 1, 1))
        self.post_quant_conv = CausalConv3d(z_dim, z_dim, (1, 1, 1))
        self.decoder = WanDecoder3d(temperal_upsample=tuple(reversed(temperal_downsample)),
                                    **common)
        init_weights(self, seed)
        self.requires_grad_(False)
        self.to(self.device).eval()

    def load_checkpoint(self, path: str):
        """A diffusers ``AutoencoderKLWan`` state_dict (or a Lightning
        ``.ckpt`` holding one), strict=False; (missing, unexpected) keys."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        own = self.state_dict()
        sd = {k: (v.reshape(own[k].shape) if k.endswith(".gamma") and k in own else v)
              for k, v in sd.items()}
        result = self.load_state_dict(sd, strict=False)
        return list(result.missing_keys), list(result.unexpected_keys)

    def _input(self, x) -> torch.Tensor:
        return _ncthw(torch.as_tensor(x, device=self.device, dtype=torch.float32))

    @torch.inference_mode()
    def encode(self, x) -> DiagonalGaussianDistribution:
        """(B, T, H, W, 3) -> the posterior over (B, T', H/8, W/8, z), the
        whole clip at once."""
        return DiagonalGaussianDistribution(_nthwc(self.quant_conv(self.encoder(self._input(x)))))

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        """(B, T', h, w, z) -> (B, T, 8 h, 8 w, 3) in [-1, 1]."""
        x = self.decoder(self.post_quant_conv(self._input(z)))
        return _nthwc(x.clamp(-1.0, 1.0))

    @torch.inference_mode()
    def encode_chunked(self, x) -> DiagonalGaussianDistribution:
        """diffusers-exact encode of a clip of T = 1 + 4k frames: the first
        frame alone, then 4-frame chunks through the feature cache."""
        x = self._input(x)
        t = x.shape[2]
        if t != 1 and (t - 1) % 4:
            raise ValueError(f"chunked encode takes T = 1 + 4k frames, got {t}")
        cache, outs = {}, []
        for i in range(1 + (t - 1) // 4):
            chunk = x[:, :, :1] if i == 0 else x[:, :, 1 + 4 * (i - 1):1 + 4 * i]
            outs.append(self.encoder(chunk, cache, [0]))
        return DiagonalGaussianDistribution(_nthwc(self.quant_conv(torch.cat(outs, dim=2))))

    @torch.inference_mode()
    def decode_chunked(self, z) -> torch.Tensor:
        """diffusers-exact decode: one latent frame a chunk -> 1 + 4k output
        frames (at the default two temporal stages), clamped to [-1, 1]."""
        x = self.post_quant_conv(self._input(z))
        cache, outs = {}, []
        for i in range(x.shape[2]):
            outs.append(self.decoder(x[:, :, i:i + 1], cache, [0]))
        return _nthwc(torch.cat(outs, dim=2).clamp(-1.0, 1.0))
