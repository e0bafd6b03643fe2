"""Hourglass diffusion transformer ("HDiT"): the post engine's velocity net.

Port of ``vqvae_from_gaussian_vae_tpu/models/hdit.py``: a token pyramid with
shifted-window attention at the outer levels (reshapes and rolls, no
gather) and global attention at the bottleneck, axial RoPE, Fourier time
features and AdaLN modulation, token merge and split as linear 2x2 pixel
(un)shuffles.

Every attention goes through ``ops/flash_attention.py:sdpa_token_major``
under the JAX gate: bf16 values and a sequence the flash kernels take (L a
multiple of 128, head dim 64 or 128, ...).  At 256x256 with patch 4 the
level-0 windows hold 64 tokens and take the einsum path; the 32x32
bottleneck (L = 1024, four heads of 64) takes the flash kernel in bf16, its
training forward and backward under autograd.  Everything else (LayerNorm,
the Dense layers, GEGLU, RoPE) is plain torch, as the JAX model computes it
in plain XLA.

Parameters are float32 and keep the JAX module's names (``patch_in``,
``FourierFeatures_0.freqs``, ``down_0_block_1.attn_norm.mod``,
``merge_0.Dense_0``, ``skip_gate_0``, ...), so that
``utils/convert.py:state_dict_from_jax`` carries a flax tree over.  The
layers the JAX model gives ``dtype`` (``qkv``, ``attn_out``, ``mlp_up``,
``mlp_down``) compute in it; the rest compute in float32, and the residual
stream is float32, as flax's type promotion makes it.  Inputs are NHWC.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.models.vit import CastLinear
from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import sdpa_token_major
from vqvae_from_gaussian_vae_tpu_torch.utils.config import as_torch_dtype

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


class FourierFeatures(nn.Module):
    """t -> [cos(2 pi t f), sin(2 pi t f)] over fixed frequencies ``freqs``
    (no gradient reaches them)."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.freqs = nn.Parameter(torch.randn(features // 2))

    def forward(self, t):
        ang = 2.0 * torch.pi * t[:, None] * self.freqs.detach()[None, :]
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class AdaLN(nn.Module):
    """A LayerNorm without affine parameters, modulated by the conditioning
    vector: x (1 + scale) + shift, both from ``mod`` (zero-initialised)."""

    def __init__(self, width: int, cond_width: int):
        super().__init__()
        self.mod = nn.Linear(cond_width, 2 * width)

    def forward(self, x, cond):
        x = F.layer_norm(x.float(), (x.shape[-1],), eps=LN_EPS)
        scale, shift = self.mod(cond).chunk(2, dim=-1)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _axial_rope(q, k, grid: Tuple[int, int]):
    """Rotary embedding along H and W: token-major (B, L, heads, hd) with L =
    H*W; the first quarter of pairs rotates with the row, the third with the
    column.  The rotation runs in float32 and is rounded back to q's dtype."""
    hd = q.shape[-1]
    gh, gw = grid
    half = hd // 2
    quarter = half // 2
    dev = q.device

    def rot(x, pos, start, n):
        theta = 10000.0 ** (-torch.arange(n, dtype=torch.float32, device=dev) / max(n, 1))
        ang = pos[:, None, None] * theta[None, None, :]  # (L, 1, n)
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1 = x[..., start:start + n].float()
        x2 = x[..., start + n:start + 2 * n].float()
        return torch.cat([x[..., :start], (x1 * cos - x2 * sin).to(x.dtype),
                          (x1 * sin + x2 * cos).to(x.dtype), x[..., start + 2 * n:]], dim=-1)

    rows = torch.arange(gh, device=dev).repeat_interleave(gw).float()
    cols = torch.arange(gw, device=dev).repeat(gh).float()
    q = rot(rot(q, rows, 0, quarter), cols, half, quarter)
    k = rot(rot(k, rows, 0, quarter), cols, half, quarter)
    return q, k


class HDiTBlock(nn.Module):
    """AdaLN -> (shifted-window or global) attention with axial RoPE ->
    AdaLN -> GEGLU MLP; ``attn_out`` and ``mlp_down`` zero-initialised."""

    def __init__(self, width: int, heads: int, window: int = 0, shift: bool = False,
                 mlp_ratio: float = 3.0, dtype=torch.float32, cond_width: int = 256):
        super().__init__()
        c, hidden = width, int(width * mlp_ratio)
        self.heads, self.window, self.shift = heads, window, shift
        self.attn_norm = AdaLN(c, cond_width)
        self.qkv = CastLinear(c, 3 * c, bias=False, dtype=dtype)
        self.attn_out = CastLinear(c, c, bias=False, dtype=dtype)
        self.mlp_norm = AdaLN(c, cond_width)
        self.mlp_up = CastLinear(c, 2 * hidden, bias=False, dtype=dtype)
        self.mlp_down = CastLinear(hidden, c, bias=False, dtype=dtype)

    def forward(self, x, cond, grid: Tuple[int, int]):
        b, l, c = x.shape
        gh, gw = grid
        hd = c // self.heads
        q, k, v = (t.reshape(b, l, self.heads, hd)
                   for t in self.qkv(self.attn_norm(x, cond)).chunk(3, dim=-1))
        q, k = _axial_rope(q, k, grid)

        if self.window and self.window < min(gh, gw):
            w = self.window
            s = w // 2 if self.shift else 0

            def to_windows(t):
                t = t.reshape(b, gh, gw, self.heads, hd)
                if s:
                    t = torch.roll(t, (-s, -s), dims=(1, 2))
                t = t.reshape(b, gh // w, w, gw // w, w, self.heads, hd)
                return t.permute(0, 1, 3, 2, 4, 5, 6).reshape(
                    b * (gh // w) * (gw // w), w * w, self.heads, hd)

            ow = sdpa_token_major(*map(to_windows, (q, k, v)))  # (b * windows, w * w, c)
            ow = ow.reshape(b, gh // w, gw // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
            ow = ow.reshape(b, gh, gw, c)
            if s:
                ow = torch.roll(ow, (s, s), dims=(1, 2))
            out = ow.reshape(b, l, c)
        else:
            out = sdpa_token_major(q, k, v)

        x = x + self.attn_out(out)
        a, g = self.mlp_up(self.mlp_norm(x, cond)).chunk(2, dim=-1)
        return x + self.mlp_down(a * _gelu(g))


class TokenMerge(nn.Module):
    """2x2 tokens -> one of ``out_width`` (a linear pixel-unshuffle)."""

    def __init__(self, in_width: int, out_width: int):
        super().__init__()
        self.Dense_0 = nn.Linear(4 * in_width, out_width, bias=False)

    def forward(self, x, grid):
        b, _, c = x.shape
        gh, gw = grid
        x = x.reshape(b, gh // 2, 2, gw // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (gh // 2) * (gw // 2), 4 * c)
        return self.Dense_0(x), (gh // 2, gw // 2)


class TokenSplit(nn.Module):
    """One token -> 2x2 of ``out_width`` (a linear pixel-shuffle)."""

    def __init__(self, in_width: int, out_width: int):
        super().__init__()
        self.out_width = out_width
        self.Dense_0 = nn.Linear(in_width, 4 * out_width, bias=False)

    def forward(self, x, grid):
        b = x.shape[0]
        gh, gw = grid
        x = self.Dense_0(x).reshape(b, gh, gw, 2, 2, self.out_width).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * 2 * gw * 2, self.out_width), (gh * 2, gw * 2)


class ImageTransformerDenoiserModelV2(nn.Module):
    """The hourglass denoiser v = f(x_t, t): NHWC x_t, t of (B,) or (1,).

    ``widths``, ``depths``, ``heads`` and ``windows`` give each level from the
    outside in; the last is the global-attention bottleneck.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, patch_size: int = 4,
                 widths: Sequence[int] = (128, 256), depths: Sequence[int] = (2, 4),
                 heads: Sequence[int] = (4, 8), windows: Sequence[int] = (8, 0),
                 mapping_width: int = 256, dtype=torch.float32):
        super().__init__()
        self.patch_size, self.out_channels = patch_size, out_channels
        self.depths = tuple(depths)
        p, n_levels = patch_size, len(widths)
        self.patch_in = nn.Linear(p * p * in_channels, widths[0])
        self.FourierFeatures_0 = FourierFeatures(mapping_width)
        self.mapping_1 = nn.Linear(mapping_width, mapping_width)
        self.mapping_2 = nn.Linear(mapping_width, mapping_width)

        def block(lv, d, name):
            setattr(self, name, HDiTBlock(widths[lv], heads[lv], windows[lv],
                                          shift=bool(d % 2) and lv < n_levels - 1, dtype=dtype,
                                          cond_width=mapping_width))

        for lv in range(n_levels - 1):
            for d in range(depths[lv]):
                block(lv, d, f"down_{lv}_block_{d}")
                block(lv, d, f"up_{lv}_block_{d}")
            setattr(self, f"merge_{lv}", TokenMerge(widths[lv], widths[lv + 1]))
            setattr(self, f"split_{lv}", TokenSplit(widths[lv + 1], widths[lv]))
            setattr(self, f"skip_gate_{lv}", nn.Parameter(torch.ones(1)))
        for d in range(depths[-1]):
            block(n_levels - 1, d, f"mid_block_{d}")
        self.norm_out = nn.LayerNorm(widths[0], eps=LN_EPS)
        self.patch_out = nn.Linear(widths[0], p * p * out_channels)

    def forward(self, x, t):
        p = self.patch_size
        b, hh, ww, ch = x.shape
        grid = (hh // p, ww // p)
        x = x.float().reshape(b, grid[0], p, grid[1], p, ch).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_in(x.reshape(b, grid[0] * grid[1], p * p * ch))

        cond = self.FourierFeatures_0(torch.atleast_1d(torch.as_tensor(t, device=x.device))
                                      .float())
        cond = self.mapping_2(_gelu(self.mapping_1(cond)))
        if cond.shape[0] == 1 and b > 1:
            cond = cond.expand(b, -1)

        n_levels = len(self.depths)
        skips, grids = [], [grid]
        for lv in range(n_levels - 1):
            for d in range(self.depths[lv]):
                x = getattr(self, f"down_{lv}_block_{d}")(x, cond, grids[-1])
            skips.append(x)
            x, g = getattr(self, f"merge_{lv}")(x, grids[-1])
            grids.append(g)
        for d in range(self.depths[-1]):
            x = getattr(self, f"mid_block_{d}")(x, cond, grids[-1])
        for lv in reversed(range(n_levels - 1)):
            x, _ = getattr(self, f"split_{lv}")(x, grids[lv + 1])
            x = x + getattr(self, f"skip_gate_{lv}") * skips[lv]
            for d in range(self.depths[lv]):
                x = getattr(self, f"up_{lv}_block_{d}")(x, cond, grids[lv])
        x = self.patch_out(self.norm_out(x))
        x = x.reshape(b, grid[0], grid[1], p, p, self.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, grid[0] * p, grid[1] * p, self.out_channels)


def init_hdit_weights(model: nn.Module, seed: int) -> None:
    """Seeded weights, as the JAX model initialises them: Dense kernels
    N(0, 1/fan_in) and zero biases; ``mod``, ``attn_out``, ``mlp_down`` and
    ``patch_out`` zero (the AdaLN residual convention: a fresh model returns
    v = 0); the Fourier frequencies N(0, 1); skip gates and the final
    LayerNorm's scale 1."""
    zero = (".mod.", "attn_out.", "mlp_down.", "patch_out.")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("freqs"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif any(z in f".{name}" for z in zero) or name.endswith("bias"):
                p.zero_()
            elif p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
            else:
                p.fill_(1.0)


def create_hdit_model(in_channels: int = 3, out_channels: int = 3, patch_size: int = 4,
                      widths: Sequence[int] = (128, 256), depths: Sequence[int] = (2, 4),
                      heads: Optional[Sequence[int]] = None, windows: Sequence[int] = (8, 0),
                      mapping_width: int = 256, dtype=torch.float32,
                      **_) -> ImageTransformerDenoiserModelV2:
    """The config factory: heads default to width // 64 (at least 1)."""
    heads = heads or tuple(max(1, w // 64) for w in widths)
    return ImageTransformerDenoiserModelV2(
        in_channels=in_channels, out_channels=out_channels, patch_size=patch_size,
        widths=tuple(widths), depths=tuple(depths), heads=tuple(heads),
        windows=tuple(windows), mapping_width=mapping_width, dtype=as_torch_dtype(dtype))
