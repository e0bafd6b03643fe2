"""FLUX: the rectified-flow MMDiT, its ControlNet and its sampler -- the
generative token decoder of ``AutoencodingFluxEngine``.

Port of ``vqvae_from_gaussian_vae_tpu/models/flux.py``: double-stream
img / txt blocks with AdaLN modulation, RMS QK-norm and multi-axis RoPE,
fused single-stream blocks, optional LoRA deltas and IP-adapter k / v
projections, the depth-limited ControlNet with zero-initialised hint and
output projections, the shifted rectified-flow schedule and the Euler loops
(``denoise``, ``denoise_controlnet`` with CFG).

Weights are bf16, as the JAX modules compute (bf16 products of float32
parameters cast at use); RoPE, the softmax, RMSNorm's and LayerNorm's
statistics run in float32.  Every attention goes through
``ops/flash_attention.py:sdpa_token_major`` on token-major (B, L, H, D)
tensors: the flash kernel on the card for bf16 at L a multiple of 128 and D
= 128 (flux-dev: 24 heads of 128), q and k cast from RoPE's float32 to bf16
first, as the JAX kernel path does; the einsum path elsewhere, which is
also the JAX package's path off the TPU.  The IP-adapter's cross-attention
(4 image tokens a query) always takes the einsum path.

Module names are the reference's (``double_blocks.0.img_attn.qkv``,
``img_mod.lin``, ``img_attn.norm.query_norm.scale``, ``img_mlp.0``,
``single_blocks.0.linear1``, ``final_layer.adaLN_modulation.1``); the LoRA
and IP-adapter weights sit under the block's ``processor``
(``processor.qkv_lora1.down``, ``processor.ip_adapter_double_stream_k_proj``),
as the reference's attention processors hold them.

``Flux`` and ``ControlNetFlux`` are built where the caller asks (``device``;
flux-dev's 11.9 B parameters go straight to the card in bf16, built on the
meta device first) and seeded by ``init_flux_weights`` from an explicit
``torch.Generator``, with the JAX init's zero layers (``ZERO_INIT``) zero.
``get_noise`` draws from a generator; the pipeline also takes the noise
injected.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import sdpa_token_major


@dataclasses.dataclass(frozen=True)
class FluxParams:
    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    qkv_bias: bool = True
    guidance_embed: bool = True


def flux_dev_params(**overrides) -> FluxParams:
    """The published flux-dev configuration."""
    return dataclasses.replace(FluxParams(), **overrides)


# ------------------------------------------------------------------ basics


def timestep_embedding(t, dim: int, max_period: int = 10000, time_factor: float = 1000.0):
    """(B,) times -> (B, dim) float32 sinusoidal embedding (cos | sin)."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def rope_cos_sin(pos, dim: int, theta: int):
    """One axis's rotary tables: (..., L, dim / 2) cos and sin, float32."""
    scale = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.float()[..., None] * omega
    return torch.cos(out), torch.sin(out)


def embed_nd(ids, axes_dim: Sequence[int], theta: int):
    """ids (B, L, n_axes) -> (cos, sin), each (B, L, 1, sum(axes) / 2), which
    broadcast over the head axis of token-major (B, L, H, D) q and k."""
    tables = [rope_cos_sin(ids[..., i], d, theta) for i, d in enumerate(axes_dim)]
    cos = torch.cat([c for c, _ in tables], dim=-1)[:, :, None]
    sin = torch.cat([s for _, s in tables], dim=-1)[:, :, None]
    return cos, sin


def apply_rope(q, k, pe):
    """Rotate (B, L, H, D) q and k by pairs of channels; float32 out."""
    cos, sin = pe

    def rot(x):
        x = x.float()
        x2 = x.reshape(*x.shape[:-1], -1, 2)
        a, b = x2[..., 0], x2[..., 1]
        return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(x.shape)

    return rot(q), rot(k)


def attention(q, k, v, pe):
    """RoPE, then softmax attention over token-major (B, L, H, D) q, k, v ->
    (B, L, H*D) through ``sdpa_token_major`` (the flash kernel on the card
    where its gate holds; it casts the float32 rotated q and k to v's bf16)."""
    qf, kf = apply_rope(q, k, pe)
    return sdpa_token_major(qf, kf, v)


class Linear(nn.Linear):
    """``nn.Linear`` whose input is cast to the weight's dtype (the JAX
    ``nn.Dense(dtype=bf16)``'s product)."""

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden_dim, dtype=dtype)
        self.out_layer = Linear(hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    """x / rms(x) (float32 statistics, eps 1e-6), rounded to x's dtype, times
    ``scale``."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        rrms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        return (xf * rrms).to(x.dtype) * self.scale


class QKNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.query_norm = RMSNorm(dim, dtype)
        self.key_norm = RMSNorm(dim, dtype)

    def forward(self, q, k, v):
        return self.query_norm(q).to(v.dtype), self.key_norm(k).to(v.dtype)


class LoRADelta(nn.Module):
    """The low-rank delta up(down(x)) (the reference's ``LoRALinearLayer``);
    ``up`` is zero at init, so a fresh delta is 0."""

    def __init__(self, in_features: int, out_features: int, rank: int = 128,
                 dtype=torch.bfloat16):
        super().__init__()
        self.down = Linear(in_features, rank, bias=False, dtype=dtype)
        self.up = Linear(rank, out_features, bias=False, dtype=dtype)

    def forward(self, x):
        return self.up(self.down(x))


class Modulation(nn.Module):
    """vec -> (shift, scale, gate) once, or twice with ``double``; each (B, 1, dim)."""

    def __init__(self, dim: int, double: bool, dtype=torch.bfloat16):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = Linear(dim, dim * self.multiplier, dtype=dtype)

    def forward(self, vec):
        parts = self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, dim=-1)
        return parts[:3], (parts[3:] if self.multiplier == 6 else None)


def _ln(x):
    """LayerNorm without affine, eps 1e-6, float32 statistics, x's dtype out."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _ip_attention(q, image_proj, k_proj, v_proj, num_heads: int):
    """The IP-adapter's cross-attention: the post-QKNorm queries (no RoPE)
    over the projected image tokens; (B, L, H*D)."""
    b, lc = image_proj.shape[:2]
    hd = q.shape[-1]
    ip_k = k_proj(image_proj).reshape(b, lc, num_heads, hd)
    ip_v = v_proj(image_proj).reshape(b, lc, num_heads, hd)
    return sdpa_token_major(q, ip_k, ip_v)


class _Processor(nn.Module):
    """The block's extra weights, named as the reference's attention
    processors hold them: LoRA deltas and IP-adapter k / v projections."""


class _Stream(nn.Module):
    """One stream of a double block: ``{img,txt}_attn.{qkv,norm,proj}``."""

    def __init__(self, hidden: int, heads: int, qkv_bias: bool, dtype):
        super().__init__()
        self.qkv = Linear(hidden, 3 * hidden, bias=qkv_bias, dtype=dtype)
        self.norm = QKNorm(hidden // heads, dtype)
        self.proj = Linear(hidden, hidden, dtype=dtype)


class DoubleStreamBlock(nn.Module):
    """The img / txt MMDiT block: joint attention over [txt, img] tokens,
    each stream its own modulation, projections and MLP; with
    ``ip_context_dim`` the IP-adapter's k / v projections (with bias) add an
    image-token cross-attention to img after both residual updates."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool = False, lora_rank: int = 0, dtype=torch.bfloat16,
                 ip_context_dim: int = 0):
        super().__init__()
        self.num_heads, self.hidden = num_heads, hidden_size
        self.lora_rank, self.ip_context_dim = lora_rank, ip_context_dim
        mlp_dim = int(hidden_size * mlp_ratio)
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(hidden_size, True, dtype))
            setattr(self, f"{s}_attn", _Stream(hidden_size, num_heads, qkv_bias, dtype))
            setattr(self, f"{s}_mlp", nn.Sequential(
                Linear(hidden_size, mlp_dim, dtype=dtype), nn.GELU(approximate="tanh"),
                Linear(mlp_dim, hidden_size, dtype=dtype)))
        if lora_rank or ip_context_dim:
            self.processor = _Processor()
        if lora_rank:
            for i in (1, 2):  # 1 img, 2 txt
                setattr(self.processor, f"qkv_lora{i}",
                        LoRADelta(hidden_size, 3 * hidden_size, lora_rank, dtype))
                setattr(self.processor, f"proj_lora{i}",
                        LoRADelta(hidden_size, hidden_size, lora_rank, dtype))
        if ip_context_dim:
            for kv in ("k", "v"):
                setattr(self.processor, f"ip_adapter_double_stream_{kv}_proj",
                        Linear(ip_context_dim, hidden_size, dtype=dtype))

    def _qkv(self, x, s: str, lora: int):
        attn = getattr(self, f"{s}_attn")
        mod = attn.qkv(x)
        if self.lora_rank:
            mod = mod + getattr(self.processor, f"qkv_lora{lora}")(x)
        b, l, _ = mod.shape
        mod = mod.reshape(b, l, 3, self.num_heads, self.hidden // self.num_heads)
        q, k, v = mod[:, :, 0], mod[:, :, 1], mod[:, :, 2]
        q, k = attn.norm(q, k, v)
        return q, k, v

    def _update(self, x, x_attn, s: str, lora: int, mod1, mod2):
        proj = getattr(self, f"{s}_attn").proj(x_attn)
        if self.lora_rank:
            proj = proj + getattr(self.processor, f"proj_lora{lora}")(x_attn)
        x = x + mod1[2] * proj
        return x + mod2[2] * getattr(self, f"{s}_mlp")((1 + mod2[1]) * _ln(x) + mod2[0])

    def forward(self, img, txt, vec, pe, image_proj=None, ip_scale: float = 1.0):
        img_mod1, img_mod2 = self.img_mod(vec)
        txt_mod1, txt_mod2 = self.txt_mod(vec)
        iq, ik, iv = self._qkv((1 + img_mod1[1]) * _ln(img) + img_mod1[0], "img", 1)
        tq, tk, tv = self._qkv((1 + txt_mod1[1]) * _ln(txt) + txt_mod1[0], "txt", 2)
        out = attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1), torch.cat([tv, iv], 1),
                        pe)
        t_len = txt.shape[1]
        img = self._update(img, out[:, t_len:], "img", 1, img_mod1, img_mod2)
        txt = self._update(txt, out[:, :t_len], "txt", 2, txt_mod1, txt_mod2)
        if self.ip_context_dim and image_proj is not None:
            ip = _ip_attention(iq, image_proj, self.processor.ip_adapter_double_stream_k_proj,
                               self.processor.ip_adapter_double_stream_v_proj, self.num_heads)
            img = img + ip_scale * ip.reshape(img.shape)
        return img, txt


class SingleStreamBlock(nn.Module):
    """The fused block over [txt, img]: one ``linear1`` gives q, k, v and the
    MLP's input, ``linear2`` takes the attention and the MLP's output; with
    ``ip_context_dim`` bias-free IP-adapter k / v projections add an
    image-token cross-attention before ``linear2``."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 lora_rank: int = 0, dtype=torch.bfloat16, ip_context_dim: int = 0):
        super().__init__()
        self.num_heads, self.hidden = num_heads, hidden_size
        self.lora_rank, self.ip_context_dim = lora_rank, ip_context_dim
        mlp_dim = int(hidden_size * mlp_ratio)
        self.linear1 = Linear(hidden_size, 3 * hidden_size + mlp_dim, dtype=dtype)
        self.linear2 = Linear(hidden_size + mlp_dim, hidden_size, dtype=dtype)
        self.norm = QKNorm(hidden_size // num_heads, dtype)
        self.modulation = Modulation(hidden_size, False, dtype)
        if lora_rank or ip_context_dim:
            self.processor = _Processor()
        if lora_rank:
            self.processor.qkv_lora = LoRADelta(hidden_size, 3 * hidden_size, lora_rank, dtype)
            self.processor.proj_lora = LoRADelta(hidden_size + mlp_dim, hidden_size, lora_rank,
                                                 dtype)
        if ip_context_dim:
            for kv in ("k", "v"):
                setattr(self.processor, f"ip_adapter_single_stream_{kv}_proj",
                        Linear(ip_context_dim, hidden_size, bias=False, dtype=dtype))

    def forward(self, x, vec, pe, image_proj=None, ip_scale: float = 1.0):
        (shift, scale, gate), _ = self.modulation(vec)
        x_mod = (1 + scale) * _ln(x) + shift
        qkv, mlp = self.linear1(x_mod).split([3 * self.hidden, self.linear1.out_features
                                              - 3 * self.hidden], dim=-1)
        if self.lora_rank:
            qkv = qkv + self.processor.qkv_lora(x_mod)
        b, l, _ = qkv.shape
        qkv = qkv.reshape(b, l, 3, self.num_heads, self.hidden // self.num_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q, k = self.norm(q, k, v)
        attn_out = attention(q, k, v, pe)
        if self.ip_context_dim and image_proj is not None:
            ip = _ip_attention(q, image_proj, self.processor.ip_adapter_single_stream_k_proj,
                               self.processor.ip_adapter_single_stream_v_proj, self.num_heads)
            attn_out = attn_out + ip_scale * ip.reshape(attn_out.shape)
        cat = torch.cat([attn_out, _gelu(mlp)], dim=-1)
        out = self.linear2(cat)
        if self.lora_rank:
            out = out + self.processor.proj_lora(cat)
        return x + gate * out


class LastLayer(nn.Module):
    def __init__(self, hidden_size: int, out_channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              Linear(hidden_size, 2 * hidden_size, dtype=dtype))
        self.linear = Linear(hidden_size, out_channels, dtype=dtype)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec)[:, None, :].chunk(2, dim=-1)
        return self.linear((1 + scale) * _ln(x) + shift)


class ImageProjModel(nn.Module):
    """A CLIP image embedding -> ``clip_extra_context_tokens`` context tokens
    (the IP-Adapter projection, then LayerNorm eps 1e-5)."""

    def __init__(self, cross_attention_dim: int = 4096, clip_embeddings_dim: int = 768,
                 clip_extra_context_tokens: int = 4, dtype=torch.bfloat16):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.clip_embeddings_dim = clip_embeddings_dim
        self.clip_extra_context_tokens = clip_extra_context_tokens
        self.proj = Linear(clip_embeddings_dim, clip_extra_context_tokens * cross_attention_dim,
                           dtype=dtype)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5, dtype=dtype)

    def forward(self, image_embeds):
        x = self.proj(image_embeds).reshape(-1, self.clip_extra_context_tokens,
                                            self.cross_attention_dim)
        n = self.norm
        return F.layer_norm(x.float(), n.normalized_shape, n.weight.float(), n.bias.float(),
                            n.eps).to(x.dtype)


class _Conditioning(nn.Module):
    """The embeddings Flux and its ControlNet share: ``img_in``, ``time_in``,
    ``guidance_in``, ``vector_in``, ``txt_in`` and the RoPE tables."""

    def __init__(self, p: FluxParams, dtype):
        super().__init__()
        self.p = p
        self.img_in = Linear(p.in_channels, p.hidden_size, dtype=dtype)
        self.time_in = MLPEmbedder(256, p.hidden_size, dtype)
        if p.guidance_embed:
            self.guidance_in = MLPEmbedder(256, p.hidden_size, dtype)
        self.vector_in = MLPEmbedder(p.vec_in_dim, p.hidden_size, dtype)
        self.txt_in = Linear(p.context_in_dim, p.hidden_size, dtype=dtype)

    def _vec_txt_pe(self, txt, txt_ids, img_ids, timesteps, y, guidance):
        p = self.p
        vec = self.time_in(timestep_embedding(timesteps, 256))
        if p.guidance_embed:
            if guidance is None:
                raise ValueError("a guidance-distilled model needs guidance")
            vec = vec + self.guidance_in(timestep_embedding(guidance, 256))
        vec = vec + self.vector_in(y)
        pe = embed_nd(torch.cat([txt_ids, img_ids], dim=1), p.axes_dim, p.theta)
        return vec, self.txt_in(txt), pe


class Flux(_Conditioning):
    """Image tokens and conditioning -> velocity tokens (B, L_img, 64).

    ``ip_context_dim`` > 0 gives every block IP-adapter projections; pass
    ``image_proj`` (``ImageProjModel``'s tokens) and ``ip_scale`` to engage
    them.  ``remat`` recomputes each block in the backward pass when a
    gradient is wanted (``torch.utils.checkpoint``), as the JAX model's
    ``nn.remat``; it does nothing at inference."""

    def __init__(self, params: FluxParams, lora_rank: int = 0, remat: bool = True,
                 ip_context_dim: int = 0, dtype=torch.bfloat16):
        super().__init__(params, dtype)
        p = params
        self.lora_rank, self.remat, self.ip_context_dim = lora_rank, remat, ip_context_dim
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(p.hidden_size, p.num_heads, p.mlp_ratio, p.qkv_bias, lora_rank,
                              dtype, ip_context_dim) for _ in range(p.depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(p.hidden_size, p.num_heads, p.mlp_ratio, lora_rank, dtype,
                              ip_context_dim) for _ in range(p.depth_single_blocks))
        self.final_layer = LastLayer(p.hidden_size, 64, dtype)

    def _block(self, blk, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def forward(self, img, img_ids, txt, txt_ids, timesteps, y,
                block_controlnet_hidden_states=None, guidance=None, image_proj=None,
                ip_scale: float = 1.0):
        img = self.img_in(img)
        vec, txt, pe = self._vec_txt_pe(txt, txt_ids, img_ids, timesteps, y, guidance)
        res = block_controlnet_hidden_states
        for i, blk in enumerate(self.double_blocks):
            img, txt = self._block(blk, img, txt, vec, pe, image_proj, ip_scale)
            if res is not None:
                img = img + res[i % len(res)]
        x = torch.cat([txt, img], dim=1)
        for blk in self.single_blocks:
            x = self._block(blk, x, vec, pe, image_proj, ip_scale)
        return self.final_layer(x[:, txt.shape[1]:], vec)


class ControlNetFlux(_Conditioning):
    """The depth-limited copy of Flux's double blocks that turns a control
    latent (B, h, w, control_channels) into per-block residuals: the hint
    stack (seven 3x3 conv + SiLU, then a zero-initialised conv, 16
    channels), a 2x2 pack into the image tokens' grid, ``pos_embed_input``,
    and a zero-initialised ``controlnet_blocks.i`` after each block."""

    def __init__(self, params: FluxParams, control_channels: int, controlnet_depth: int = 2,
                 dtype=torch.bfloat16):
        super().__init__(params, dtype)
        p = params
        self.control_channels = control_channels
        hint: List[nn.Module] = []
        for i in range(8):
            hint.append(nn.Conv2d(control_channels if i == 0 else 16, 16, 3, padding=1,
                                  dtype=dtype))
            if i < 7:
                hint.append(nn.SiLU())
        self.input_hint_block = nn.Sequential(*hint)
        self.pos_embed_input = Linear(64, p.hidden_size, dtype=dtype)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(p.hidden_size, p.num_heads, p.mlp_ratio, p.qkv_bias, 0, dtype)
            for _ in range(controlnet_depth))
        self.controlnet_blocks = nn.ModuleList(
            Linear(p.hidden_size, p.hidden_size, dtype=dtype) for _ in range(controlnet_depth))

    def forward(self, img, img_ids, controlnet_cond, txt, txt_ids, timesteps, y, guidance=None):
        img = self.img_in(img)
        conv = self.input_hint_block[0]
        h = self.input_hint_block(controlnet_cond.to(conv.weight.dtype).permute(0, 3, 1, 2))
        h = h.permute(0, 2, 3, 1)
        b, hh, ww, c = h.shape
        h = h.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        img = img + self.pos_embed_input(h.reshape(b, (hh // 2) * (ww // 2), c * 4))
        vec, txt, pe = self._vec_txt_pe(txt, txt_ids, img_ids, timesteps, y, guidance)
        residuals = []
        for blk, out in zip(self.double_blocks, self.controlnet_blocks):
            img, txt = blk(img, txt, vec, pe)
            residuals.append(out(img))
        return tuple(residuals)


# --------------------------------------------------------------- weights

# the layers the JAX init zeroes: the final projection, the ControlNet's
# output projections and last hint conv, LoRA's up and the IP k / v weights
ZERO_INIT = re.compile(r"^final_layer\.linear\.weight$|^controlnet_blocks\.\d+\.weight$"
                       r"|^input_hint_block\.14\.weight$|_lora\d?\.up\.weight$"
                       r"|\.ip_adapter_\w+\.weight$")


def build(cls, *args, device=None, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` on the meta device, then its storage on
    ``device`` (uninitialised: seed it with ``init_flux_weights``), so that
    flux-dev is never built in float32 or on the host."""
    with torch.device("meta"):
        module = cls(*args, **kwargs)
    return module.to_empty(device=device or "cpu").eval()


@torch.no_grad()
def init_flux_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights on the module's own device, as the JAX init draws
    them: Linear and conv weights N(0, 1/fan_in) (LoRA's ``down`` N(0,
    1/rank^2)), biases 0, RMSNorm scales and LayerNorm weights 1, and the
    ``ZERO_INIT`` layers 0.  ``generator`` lives on the module's device."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if ZERO_INIT.search(name) or leaf == "bias":
            p.zero_()
        elif p.dim() in (2, 4):
            lora_down = re.search(r"_lora\d?\.down\.weight$", name) is not None
            std = 1.0 / p.shape[0] if lora_down else p[0].numel() ** -0.5
            p.normal_(0.0, std, generator=generator)
        else:
            p.fill_(1.0)


# ---------------------------------------------------------------- sampling


def time_shift(mu: float, sigma: float, t):
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def get_lin_function(x1=256.0, y1=0.5, x2=4096.0, y2=1.15):
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def get_schedule(num_steps: int, image_seq_len: int, base_shift: float = 0.5,
                 max_shift: float = 1.15, shift: bool = True) -> List[float]:
    """num_steps + 1 times from 1 to 0, shifted towards 1 for long sequences."""
    ts = np.linspace(1.0, 0.0, num_steps + 1)
    if shift:
        mu = get_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
        with np.errstate(divide="ignore"):
            ts = np.where(ts > 0, time_shift(mu, 1.0, np.clip(ts, 1e-9, 1.0)), 0.0)
        ts[-1] = 0.0
    return [float(t) for t in ts]


def get_noise(generator: Optional[torch.Generator], num_samples: int, height: int, width: int,
              device=None):
    """Latent noise (B, 2 ceil(H / 16), 2 ceil(W / 16), 16) float32, NHWC,
    drawn channel-major as the reference draws it."""
    shape = (num_samples, 16, 2 * math.ceil(height / 16), 2 * math.ceil(width / 16))
    return torch.randn(shape, generator=generator, device=device).permute(0, 2, 3, 1)


def pack_latents(z):
    """(B, H, W, C) -> (B, H/2 W/2, 4C) tokens, channels ordered (c ph pw)."""
    b, h, w, c = z.shape
    z = z.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return z.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(x, height: int, width: int):
    """``pack_latents``'s inverse for an image of height x width, NHWC out."""
    b = x.shape[0]
    h, w = math.ceil(height / 16), math.ceil(width / 16)
    x = x.reshape(b, h, w, -1, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * 2, w * 2, -1)


def make_img_ids(h_latent: int, w_latent: int, bs: int, device=None):
    """(bs, h/2 w/2, 3) float32 positions: (0, row, column) of each token."""
    ids = np.zeros((h_latent // 2, w_latent // 2, 3), np.float32)
    ids[..., 1] += np.arange(h_latent // 2)[:, None]
    ids[..., 2] += np.arange(w_latent // 2)[None, :]
    return torch.tensor(np.tile(ids.reshape(1, -1, 3), (bs, 1, 1)), device=device)


def _ip_kwargs(image_proj, ip_scale):
    return {} if image_proj is None else {"image_proj": image_proj, "ip_scale": ip_scale}


def denoise(model_apply, img, img_ids, txt, txt_ids, vec, timesteps: List[float],
            guidance: float = 4.0, image_proj=None, ip_scale: float = 1.0):
    """The guided Euler loop, no ControlNet, no CFG; ``image_proj`` engages
    the IP-adapter."""
    guidance_vec = torch.full((img.shape[0],), guidance, dtype=torch.float32,
                              device=img.device)
    for t_curr, t_prev in zip(timesteps[:-1], timesteps[1:]):
        t_vec = torch.full((img.shape[0],), t_curr, dtype=torch.float32, device=img.device)
        pred = model_apply(img=img, img_ids=img_ids, txt=txt, txt_ids=txt_ids, timesteps=t_vec,
                           y=vec, guidance=guidance_vec, **_ip_kwargs(image_proj, ip_scale))
        img = img + (t_prev - t_curr) * pred.to(img.dtype)
    return img


def denoise_controlnet(model_apply, controlnet_apply, img, img_ids, txt, txt_ids, vec,
                       neg_txt, neg_txt_ids, neg_vec, controlnet_cond, timesteps: List[float],
                       guidance: float = 4.0, true_gs: float = 1.0, controlnet_gs: float = 0.7,
                       timestep_to_start_cfg: int = 0, image_proj=None, neg_image_proj=None,
                       ip_scale: float = 1.0, neg_ip_scale: float = 1.0):
    """The CFG + ControlNet Euler loop: each step the ControlNet's residuals
    (times ``controlnet_gs``) feed the positive pass and, from step
    ``timestep_to_start_cfg`` on, a negative pass, combined as neg + true_gs
    (pos - neg).  The negative pass runs only on those steps (the JAX loop
    runs it on every step and selects the positive prediction before them:
    the same result)."""
    guidance_vec = torch.full((img.shape[0],), guidance, dtype=torch.float32,
                              device=img.device)
    for i, (t_curr, t_prev) in enumerate(zip(timesteps[:-1], timesteps[1:])):
        t_vec = torch.full((img.shape[0],), t_curr, dtype=torch.float32, device=img.device)
        residuals = controlnet_apply(img=img, img_ids=img_ids, controlnet_cond=controlnet_cond,
                                     txt=txt, txt_ids=txt_ids, timesteps=t_vec, y=vec,
                                     guidance=guidance_vec)
        residuals = [r * controlnet_gs for r in residuals]
        pred = model_apply(img=img, img_ids=img_ids, txt=txt, txt_ids=txt_ids, timesteps=t_vec,
                           y=vec, block_controlnet_hidden_states=residuals,
                           guidance=guidance_vec, **_ip_kwargs(image_proj, ip_scale))
        if i >= timestep_to_start_cfg:
            neg_pred = model_apply(img=img, img_ids=img_ids, txt=neg_txt, txt_ids=neg_txt_ids,
                                   timesteps=t_vec, y=neg_vec,
                                   block_controlnet_hidden_states=residuals,
                                   guidance=guidance_vec,
                                   **_ip_kwargs(neg_image_proj, neg_ip_scale))
            pred = neg_pred + true_gs * (pred - neg_pred)
        img = img + (t_prev - t_curr) * pred.to(img.dtype)
    return img
