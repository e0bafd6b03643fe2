"""The attention zoo.

Port of ``vqvae_from_gaussian_vae_tpu/models/attention.py``: the Stable
Diffusion attention pieces (cross-attention, timm-style self-attention, the
spatial single-head block, the GEGLU feed-forward, the transformer blocks
and the spatial transformer).  No model of either package calls them; they
are kept for parity and for conditioning extensions.  The JAX package
computes them in plain XLA, so the port computes them in plain torch: no
kernel backs any of them.

Sequence inputs are (B, L, C); the spatial modules take and return NHWC
tensors, as the JAX modules do.  Parameter names are the JAX modules' names
with ``.`` for a list index (``to_out.0``, ``net.2``, ``layers.1``,
``transformer_blocks.0``), the reference's state_dict names, so that
``utils/convert.py:state_dict_from_jax`` carries the JAX parameters over
and the JAX package's ``convert_state_dict`` carries them back.  Dense
layers keep float32 weights and compute in ``dtype`` (``CastLinear``,
``CastConv2d``); LayerNorm runs in float32 (eps 1e-6, flax's default), and
the attention's softmax in float32 before the P.V product in ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vqvae_from_gaussian_vae_tpu_torch.models.unet import (  # noqa: F401 (re-export)
    CastConv2d, LinAttnBlock, Normalize, _nchw, _nhwc)
from vqvae_from_gaussian_vae_tpu_torch.models.vit import CastLinear


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm()``: eps 1e-6, computed and returned in float32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def _sdpa(q, k, v, scale: float, mask=None):
    """(B, H, Lq, D) x (B, H, Lk, D): float32 scores and softmax, P.V in v's
    dtype; ``mask`` (B, Lk) keeps the keys where it is true."""
    attn = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if mask is not None:
        attn = attn.masked_fill(~mask[:, None, None, :].bool(), float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(attn, dim=-1).to(v.dtype), v)


class CrossAttention(nn.Module):
    """q from x, k and v from ``context`` (or x); an optional key mask."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        kv_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = CastLinear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = CastLinear(kv_dim, inner, bias=False, dtype=dtype)
        self.to_v = CastLinear(kv_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([CastLinear(inner, query_dim, dtype=dtype)])

    def forward(self, x, context=None, mask=None):
        context = x if context is None else context
        b, lq, _ = x.shape
        lk = context.shape[1]

        def heads(t, l):
            return t.reshape(b, l, self.heads, self.dim_head).transpose(1, 2)

        out = _sdpa(heads(self.to_q(x), lq), heads(self.to_k(context), lk),
                    heads(self.to_v(context), lk), self.dim_head ** -0.5, mask)
        return self.to_out[0](out.transpose(1, 2).reshape(b, lq, self.heads * self.dim_head))


MemoryEfficientCrossAttention = CrossAttention


class SelfAttention(nn.Module):
    """timm-style multi-head self-attention with a packed ``qkv`` Linear."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = CastLinear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = CastLinear(dim, dim, dtype=dtype)

    def forward(self, x):
        b, l, _ = x.shape
        qkv = self.qkv(x).reshape(b, l, 3, self.num_heads, self.dim // self.num_heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = _sdpa(q, k, v, self.scale)
        return self.proj(out.transpose(1, 2).reshape(b, l, self.dim))


class SpatialSelfAttention(nn.Module):
    """Single-head attention over the NHWC grid, 1x1-conv q, k, v and
    ``proj_out`` after a GroupNorm, plus the input."""

    def __init__(self, in_channels: int, dtype=torch.float32):
        super().__init__()
        c = in_channels
        self.norm = Normalize(c)
        self.q = CastConv2d(c, c, 1, dtype=dtype)
        self.k = CastConv2d(c, c, 1, dtype=dtype)
        self.v = CastConv2d(c, c, 1, dtype=dtype)
        self.proj_out = CastConv2d(c, c, 1, dtype=dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.norm(_nchw(x))
        q, k, v = (_nhwc(conv(y)).reshape(b, 1, h * w, c) for conv in (self.q, self.k, self.v))
        y = _sdpa(q, k, v, c ** -0.5).reshape(b, h, w, c)
        return x + _nhwc(self.proj_out(_nchw(y)))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.proj = CastLinear(dim_in, 2 * dim_out, dtype=dtype)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")  # jax.nn.gelu's default form


class FeedForward(nn.Module):
    """GEGLU (or Dense + GELU) MLP; ``net.1`` is the reference's dropout slot."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4,
                 glu: bool = True, dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        self.glu = glu
        first = GEGLU(dim, inner, dtype) if glu else CastLinear(dim, inner, dtype=dtype)
        self.net = nn.ModuleList([first, nn.Identity(),
                                  CastLinear(inner, dim_out or dim, dtype=dtype)])

    def forward(self, x):
        x = self.net[0](x)
        if not self.glu:
            x = F.gelu(x, approximate="tanh")
        return self.net[2](x)


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention, cross-attention and GEGLU feed-forward."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None,
                 disable_self_attn: bool = False, dtype=torch.float32):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None,
                                    n_heads, d_head, dtype)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dtype)
        self.ff = FeedForward(dim, dtype=dtype)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x), context=context if self.disable_self_attn else None)
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class BasicTransformerSingleLayerBlock(nn.Module):
    """One pre-LN (cross-)attention and one feed-forward."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None,
                 gated_ff: bool = True, remat: bool = False, dtype=torch.float32):
        super().__init__()
        del remat  # accepted as the JAX module's; one block has nothing to recompute apart
        self.attn1 = CrossAttention(dim, context_dim, n_heads, d_head, dtype)
        self.ff = FeedForward(dim, glu=gated_ff, dtype=dtype)
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x), context=context) + x
        return self.ff(self.norm2(x)) + x


class SimpleTransformer(nn.Module):
    """A stack of BasicTransformerBlocks; with ``remat`` each block's
    activations are recomputed in the backward pass."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, remat: bool = False, dtype=torch.float32):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            BasicTransformerBlock(dim, heads, dim_head, context_dim=context_dim, dtype=dtype)
            for _ in range(depth))

    def forward(self, x, context=None):
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, context, use_reentrant=False)
            else:
                x = layer(x, context)
        return x


class SpatialTransformer(nn.Module):
    """GroupNorm, 1x1 ``proj_in``, transformer blocks over the flattened NHWC
    grid, 1x1 ``proj_out``, plus the input."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        inner = n_heads * d_head
        self.norm = Normalize(in_channels)
        self.proj_in = CastConv2d(in_channels, inner, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim=context_dim, dtype=dtype)
            for _ in range(depth))
        self.proj_out = CastConv2d(inner, in_channels, 1, dtype=dtype)
        nn.init.zeros_(self.proj_out.weight)  # the JAX module's zero init
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x, context=None):
        b, h, w, _ = x.shape
        y = _nhwc(self.proj_in(self.norm(_nchw(x))))
        y = y.reshape(b, h * w, y.shape[-1])
        for block in self.transformer_blocks:
            y = block(y, context=context)
        y = self.proj_out(_nchw(y.reshape(b, h, w, -1)))
        return _nhwc(y) + x
