"""HunyuanVAE2D, the HunyuanImage VAE.

Port of ``vqvae_from_gaussian_vae_tpu/models/hyvae.py``: a diffusers-style
conv VAE whose resamplers are residual -- ``Downsample`` is a 3x3 conv then
a 2x2 pixel-unshuffle, plus the unshuffled input averaged over channel
groups; ``Upsample`` is a 3x3 conv then a pixel-shuffle, plus the input's
channels repeated and shuffled -- with mean-shortcut heads into and out of
the latent and mid-block attention (the UNet's ``AttnBlock``).

Parameter names are the reference's state_dict names
(``encoder.down.0.block.1.conv1.weight``, ``encoder.down.0.downsample.conv``,
``encoder.mid.attn_1.q``, ``decoder.up.2.upsample.conv``, conv weights OIHW).
``Encoder`` and ``Decoder`` take and return NHWC tensors; the pixel
(un)shuffles order channels (r1 r2 c), as the JAX package does.

``HunyuanVAE2D`` is an ``nn.Module`` on the CUDA device unless the caller
passes ``device="cpu"``, with seeded weights: ``encode`` returns the
channel-last ``DiagonalGaussianDistribution``, whose ``sample`` takes an
explicit ``torch.Generator`` or an injected ``eps``.  ``use_slicing`` runs
a batch one image at a time; ``use_spatial_tiling`` (off by default, as in
the JAX package: the pretrained checkpoint tiles with artifacts) encodes
and decodes overlapping tiles blended by ``blend_h`` / ``blend_v``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import init_weights, resolve_device
from vqvae_from_gaussian_vae_tpu_torch.models.unet import (
    AttnBlock, CastConv2d, Normalize, nonlinearity)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class DiagonalGaussianDistribution:
    """Channel-last: ``parameters`` (..., 2C) -> mean and log-variance (...,
    C), the log-variance clipped to [-30, 20]."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = torch.chunk(parameters, 2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)
        if deterministic:
            self.std = torch.zeros_like(self.mean)
            self.var = torch.zeros_like(self.mean)

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps drawn from ``generator`` unless given."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                              dtype=self.mean.dtype)
        return self.mean + self.std * eps.to(self.mean.device, self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var + self.var / other.var
                               - 1.0 - self.logvar + other.logvar, dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=dims)


class ResnetBlock(nn.Module):
    """norm1 -> swish -> conv1 -> norm2 -> swish -> conv2, plus the input
    (a 1x1 ``nin_shortcut`` where the width changes); NCHW inside."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = Normalize(in_channels)
        self.conv1 = CastConv2d(in_channels, out_ch, 3, padding=1, dtype=dtype)
        self.norm2 = Normalize(out_ch)
        self.conv2 = CastConv2d(out_ch, out_ch, 3, padding=1, dtype=dtype)
        if in_channels != out_ch:
            self.nin_shortcut = CastConv2d(in_channels, out_ch, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(nonlinearity(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


def pixel_unshuffle(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, 2H', 2W', C) -> (B, H', W', 4C), channels ordered (r1 r2 c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H', W', 4C) -> (B, 2H', 2W', C), channels ordered (r1 r2 c)."""
    b, h, w, c4 = x.shape
    x = x.reshape(b, h, w, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c4 // 4)


class Downsample(nn.Module):
    """conv (out / 4 channels) -> pixel-unshuffle, plus the unshuffled input
    averaged over groups of 4 in / out channels; NCHW in and out."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.group_size = 4 * in_channels // out_channels
        self.conv = CastConv2d(in_channels, out_channels // 4, 3, padding=1, dtype=dtype)

    def forward(self, x):
        h = pixel_unshuffle(_nhwc(self.conv(x)))
        shortcut = pixel_unshuffle(_nhwc(x))
        b, hh, ww, c = shortcut.shape
        shortcut = shortcut.reshape(b, hh, ww, c // self.group_size, self.group_size).mean(-1)
        return _nchw(h + shortcut)


class Upsample(nn.Module):
    """conv (4 out channels) -> pixel-shuffle, plus the input's channels
    each repeated 4 out / in times, shuffled; NCHW in and out."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.repeats = 4 * out_channels // in_channels
        self.conv = CastConv2d(in_channels, out_channels * 4, 3, padding=1, dtype=dtype)

    def forward(self, x):
        h = pixel_shuffle(_nhwc(self.conv(x)))
        shortcut = pixel_shuffle(torch.repeat_interleave(_nhwc(x), self.repeats, dim=-1))
        return _nchw(h + shortcut)


class _Level(nn.Module):
    """One resolution: ``block`` (the resblocks), then its ``downsample`` or
    ``upsample`` where it has one."""

    def __init__(self, specs, resample: Optional[nn.Module], name: str, dtype):
        super().__init__()
        self.block = nn.ModuleList(ResnetBlock(i, o, dtype=dtype) for i, o in specs)
        if resample is not None:
            setattr(self, name, resample)
        self.resample_name = name if resample is not None else None

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        if self.resample_name is not None:
            x = getattr(self, self.resample_name)(x)
        return x


class _Mid(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, dtype=dtype)
        self.attn_1 = AttnBlock(channels, dtype=dtype)
        self.block_2 = ResnetBlock(channels, channels, dtype=dtype)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    """(B, H, W, in_channels) -> (B, H/f, W/f, 2 z_channels) moments."""

    def __init__(self, in_channels: int, z_channels: int, block_out_channels: Sequence[int],
                 num_res_blocks: int, ffactor_spatial: int, downsample_match_channel: bool = True,
                 dtype=torch.float32):
        super().__init__()
        chans = list(block_out_channels)
        assert chans[-1] % (2 * z_channels) == 0
        self.z_channels = z_channels
        self.group_size = chans[-1] // (2 * z_channels)
        self.conv_in = CastConv2d(in_channels, chans[0], 3, padding=1, dtype=dtype)
        block_in, levels = chans[0], []
        n_down = int(math.log2(ffactor_spatial))
        for i_level, ch in enumerate(chans):
            specs = []
            for _ in range(num_res_blocks):
                specs.append((block_in, ch))
                block_in = ch
            resample = None
            if i_level < n_down:
                out = chans[i_level + 1] if downsample_match_channel else block_in
                resample = Downsample(block_in, out, dtype=dtype)
                block_in = out
            levels.append(_Level(specs, resample, "downsample", dtype))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in, dtype)
        self.norm_out = Normalize(block_in)
        self.conv_out = CastConv2d(block_in, 2 * z_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        h = self.conv_in(_nchw(x))
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        b, c, hh, ww = h.shape
        # the mean shortcut into the moments: consecutive channel groups averaged
        shortcut = _nhwc(h).reshape(b, hh, ww, 2 * self.z_channels, self.group_size).mean(-1)
        h = self.conv_out(nonlinearity(self.norm_out(h)))
        return _nhwc(h) + shortcut


class Decoder(nn.Module):
    """(B, h, w, z_channels) -> (B, h f, w f, out_channels)."""

    def __init__(self, z_channels: int, out_channels: int, block_out_channels: Sequence[int],
                 num_res_blocks: int, ffactor_spatial: int, upsample_match_channel: bool = True,
                 dtype=torch.float32):
        super().__init__()
        chans = list(block_out_channels)
        assert chans[0] % z_channels == 0
        self.repeats = chans[0] // z_channels
        block_in = chans[0]
        self.conv_in = CastConv2d(z_channels, block_in, 3, padding=1, dtype=dtype)
        self.mid = _Mid(block_in, dtype)
        n_up, levels = int(math.log2(ffactor_spatial)), []
        for i_level, ch in enumerate(chans):
            specs = []
            for _ in range(num_res_blocks + 1):
                specs.append((block_in, ch))
                block_in = ch
            resample = None
            if i_level < n_up:
                out = chans[i_level + 1] if upsample_match_channel else block_in
                resample = Upsample(block_in, out, dtype=dtype)
                block_in = out
            levels.append(_Level(specs, resample, "upsample", dtype))
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(block_in)
        self.conv_out = CastConv2d(block_in, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z):
        h = self.conv_in(_nchw(z)) + _nchw(torch.repeat_interleave(z, self.repeats, dim=-1))
        h = self.mid(h)
        for level in self.up:
            h = level(h)
        return _nhwc(self.conv_out(nonlinearity(self.norm_out(h))))


class HunyuanVAE2D(nn.Module):
    """encode -> ``DiagonalGaussianDistribution``, decode, with the scaling and
    shift factors kept for callers, batch slicing and default-off tiling."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, ffactor_spatial: int = 8, sample_size: int = 256,
                 sample_tsize: int = 1, scaling_factor: Optional[float] = None,
                 shift_factor: Optional[float] = None, downsample_match_channel: bool = True,
                 upsample_match_channel: bool = True, seed: int = 0, device=None, **kwargs):
        super().__init__()
        del sample_tsize, kwargs  # the reference's video and diffusers config keys
        self.ffactor_spatial = ffactor_spatial
        self.scaling_factor = scaling_factor
        self.shift_factor = shift_factor
        self.latent_channels = latent_channels
        self.encoder = Encoder(in_channels, latent_channels, tuple(block_out_channels),
                               layers_per_block, ffactor_spatial, downsample_match_channel)
        self.decoder = Decoder(latent_channels, out_channels,
                               tuple(reversed(block_out_channels)), layers_per_block,
                               ffactor_spatial, upsample_match_channel)
        self.use_slicing = False
        self.use_spatial_tiling = False
        self.tile_sample_min_size = sample_size
        self.tile_latent_min_size = sample_size // ffactor_spatial
        self.tile_overlap_factor = 0.25
        self.device = resolve_device(device)
        self.init_params(seed)

    def init_params(self, seed: int = 0) -> None:
        """Seeded weights (``models/autoencoder.py:init_weights``), on the device."""
        self.to("cpu")
        init_weights(self, seed)
        self.to(self.device, memory_format=torch.channels_last)

    def load_checkpoint(self, path: str):
        """A converted reference state_dict (or a Lightning .ckpt), read with
        ``weights_only=True``, strict=False; (missing, unexpected) keys."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        result = self.load_state_dict(sd, strict=False)
        return list(result.missing_keys), list(result.unexpected_keys)

    # ----------------------------------------------------------- tiling

    @staticmethod
    def blend_h(a: torch.Tensor, b: torch.Tensor, blend_extent: int) -> torch.Tensor:
        """NHWC: b's first columns faded in from a's last ones, along W."""
        blend = min(a.shape[2], b.shape[2], blend_extent)
        w = torch.arange(blend, device=b.device, dtype=b.dtype) / blend
        b = b.clone()
        b[:, :, :blend] = a[:, :, -blend:] * (1 - w)[None, None, :, None] \
            + b[:, :, :blend] * w[None, None, :, None]
        return b

    @staticmethod
    def blend_v(a: torch.Tensor, b: torch.Tensor, blend_extent: int) -> torch.Tensor:
        """NHWC: b's first rows faded in from a's last ones, along H."""
        blend = min(a.shape[1], b.shape[1], blend_extent)
        w = torch.arange(blend, device=b.device, dtype=b.dtype) / blend
        b = b.clone()
        b[:, :blend] = a[:, -blend:] * (1 - w)[None, :, None, None] \
            + b[:, :blend] * w[None, :, None, None]
        return b

    def _tiled(self, x, fn, tile: int, out_tile: int):
        """Run ``fn`` on tiles of ``tile`` pixels that overlap by the overlap
        factor, blend each with its upper and left neighbours and keep the
        ``out_tile``-sized core of each (the diffusers tiling)."""
        overlap = int(tile * (1 - self.tile_overlap_factor))
        blend = int(out_tile * self.tile_overlap_factor)
        limit = out_tile - blend
        rows = [[fn(x[:, i:i + tile, j:j + tile]) for j in range(0, x.shape[2], overlap)]
                for i in range(0, x.shape[1], overlap)]
        out_rows = []
        for i, row in enumerate(rows):
            out = []
            for j, t in enumerate(row):
                if i > 0:
                    t = self.blend_v(rows[i - 1][j], t, blend)
                if j > 0:
                    t = self.blend_h(row[j - 1], t, blend)
                out.append(t[:, :limit, :limit])
            out_rows.append(torch.cat(out, dim=2))
        return torch.cat(out_rows, dim=1)

    # ----------------------------------------------------------- API

    def _encode_moments(self, x):
        if self.use_spatial_tiling and max(x.shape[1:3]) > self.tile_sample_min_size:
            return self._tiled(x, self.encoder, self.tile_sample_min_size,
                               self.tile_latent_min_size)
        return self.encoder(x)

    def _decode(self, z):
        if self.use_spatial_tiling and max(z.shape[1:3]) > self.tile_latent_min_size:
            return self._tiled(z, self.decoder, self.tile_latent_min_size,
                               self.tile_sample_min_size)
        return self.decoder(z)

    def encode(self, x) -> DiagonalGaussianDistribution:
        """NHWC x -> the posterior over the latent."""
        if self.use_slicing and x.shape[0] > 1:
            moments = torch.cat([self._encode_moments(x[i:i + 1]) for i in range(x.shape[0])])
        else:
            moments = self._encode_moments(x)
        return DiagonalGaussianDistribution(moments)

    def decode(self, z):
        if self.use_slicing and z.shape[0] > 1:
            return torch.cat([self._decode(z[i:i + 1]) for i in range(z.shape[0])])
        return self._decode(z)

    def forward(self, sample, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = False, eps: Optional[torch.Tensor] = None):
        posterior = self.encode(sample)
        z = posterior.sample(generator, eps) if sample_posterior else posterior.mode()
        return self.decode(z)
