"""BSQ-ViT transformer backbone ("bsqvit").

Port of ``vqvae_from_gaussian_vae_tpu/models/vit.py``: Linear patchify with
the channel-major (c, sh, sw) patch-feature order, a learned positional
embedding, pre-LN residual attention blocks (packed-QKV multi-head
attention, GELU MLP, optional LayerScale), causal / block-causal masks, the
encoder's quant_embed head and the decoder's tanh-FFN output head.
Parameter names are the reference's ``pit`` state_dict names
(``transformer.resblocks.0.attn.in_proj_weight``, Linear weights (O, I),
LayerNorm ``weight``/``bias``, ``ffn.0``).

Layout: tokens are batch-first (B, L, C) throughout; images NHWC.  Every
parameter is float32, the optimizer's master copy; the Linear projections
cast their weights and inputs to the compute ``dtype`` at use, as the JAX
package's Dense layers do, so the gradients reach the float32 weights
through the casts.

Each LayerNorm goes through ``ops/layer_norm.py`` (the residual add fused
into the next norm's read, as the JAX model's streamed pre-LN trunk does)
and, on the bf16 path, each unmasked attention through the packed flash
entry ``ops/flash_attention.py:flash_attention_qkv``, where the JAX model
takes its kernels (``layer_norm_uses_kernel``, ``mha_uses_flash``: the JAX
conditions less their "backend is TPU" clause, read at each call, with
``GVQ_DISABLE_FUSED_KERNELS=1`` turning both off); elsewhere the plain
LayerNorm and the einsum attention run, on the card too.  The device only
decides, inside each op, between the kernel and its plain version; when a
gradient is wanted, each op runs its training forward and backward kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import (
    flash_attention_qkv, flash_supported, kernels_disabled)
from vqvae_from_gaussian_vae_tpu_torch.ops.layer_norm import (
    layer_norm, layer_norm_add, layer_norm_add_plain, layer_norm_plain)
from vqvae_from_gaussian_vae_tpu_torch.utils.config import as_torch_dtype


class CastLinear(nn.Linear):
    """``nn.Linear`` with float32 weights, computed in ``dtype``: the input,
    weight and bias are cast at use (the JAX package's ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = as_torch_dtype(dtype)

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def layer_norm_uses_kernel(c: int) -> bool:
    """The JAX ``FusedLayerNorm``'s kernel gate, less its TPU and init
    clauses: rows whose width C is a multiple of 128, the kernels not
    disabled."""
    return c % 128 == 0 and not kernels_disabled()


def mha_uses_flash(flash: bool, masked: bool, dtype, l: int, n_head: int, head_dim: int) -> bool:
    """The JAX ``MultiheadAttention``'s flash gate, less its TPU clause: the
    ``flash`` field, no mask, a shape the kernels take (``flash_supported``,
    which differs from JAX's ``flash_blc_supported`` as its module says) and
    the kernels not disabled; and bf16 values, since the port's flash kernels
    take bf16 only (a float32 ViT keeps the einsum path, where JAX on a TPU
    would run its float32 kernel)."""
    return (flash and not masked and dtype == torch.bfloat16
            and flash_supported(l, n_head, head_dim) and not kernels_disabled())


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, float32 statistics, output in
    ``dtype``; with ``add`` the fused pair (s, y) = (x + add, LN(x + add))
    that the streamed residual trunk uses.  The kernels run where
    ``layer_norm_uses_kernel`` holds; elsewhere the plain versions, with
    autograd for their backward."""

    def __init__(self, width: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = as_torch_dtype(dtype)
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x, add=None):
        kernel = layer_norm_uses_kernel(x.shape[-1])
        if add is not None:
            fn = layer_norm_add if kernel else layer_norm_add_plain
            return fn(x.to(self.dtype), add.to(self.dtype), self.weight, self.bias, self.eps)
        fn = layer_norm if kernel else layer_norm_plain
        return fn(x.to(self.dtype), self.weight, self.bias, self.eps)


def get_attention_mask(sequence_length: int, mask_type: str = "none", block_size: int = 16,
                       device=None) -> Optional[torch.Tensor]:
    """Additive (-inf) float32 disable mask, or None."""
    if mask_type is None or mask_type.lower() == "none":
        return None
    if mask_type.lower() == "causal":
        full = torch.full((sequence_length, sequence_length), float("-inf"), device=device)
        return torch.triu(full, diagonal=1)
    if mask_type.lower() == "block-causal":
        assert sequence_length % block_size == 0
        blocks = np.kron(np.eye(sequence_length // block_size), np.ones((block_size, block_size)))
        causal = np.tril(np.ones((sequence_length, sequence_length)))
        disable = (blocks + causal) < 0.5
        mask = np.where(disable, -np.inf, 0.0).astype(np.float32)
        return torch.from_numpy(mask).to(device)
    raise NotImplementedError(f"Mask type {mask_type} not implemented")


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``-compatible packed-QKV self-attention
    on batch-first tokens.  Where ``mha_uses_flash`` holds, it reads q, k, v
    in place from the (B, L, 3C) projection through ``flash_attention_qkv``;
    elsewhere (``flash=False``, a mask, float32, a shape the kernels do not
    take, the kernels disabled) the einsum form with a float32 softmax."""

    def __init__(self, d_model: int, n_head: int, flash: bool = True, dtype=torch.float32):
        super().__init__()
        self.n_head = n_head
        self.flash = flash
        self.dtype = as_torch_dtype(dtype)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = CastLinear(d_model, d_model, dtype=dtype)

    def forward(self, x, attn_mask=None):
        b, l, c = x.shape
        hd = c // self.n_head
        qkv = F.linear(x.to(self.dtype), self.in_proj_weight.to(self.dtype),
                       self.in_proj_bias.to(self.dtype))
        if mha_uses_flash(self.flash, attn_mask is not None, qkv.dtype, l, self.n_head, hd):
            out = flash_attention_qkv(qkv, hd ** -0.5, self.n_head)
        else:
            q, k, v = (t.reshape(b, l, self.n_head, hd) for t in qkv.chunk(3, dim=-1))
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
            if attn_mask is not None:
                attn = attn + attn_mask
            attn = torch.softmax(attn, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, l, c)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, width: int, mlp_width: int, dtype=torch.float32):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.c_fc = CastLinear(width, mlp_width, dtype=dtype)
        self.c_proj = CastLinear(mlp_width, width, dtype=dtype)

    def forward(self, x):
        x = self.c_fc(x)
        # bf16 takes the tanh approximation, float32 the exact erf, as the
        # JAX model does
        x = F.gelu(x, approximate="tanh" if self.dtype == torch.bfloat16 else "none")
        return self.c_proj(x)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual block (the only kind the encoder and decoder build);
    dropout and drop-path are inference no-ops and not modelled."""

    def __init__(self, d_model: int, n_head: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, dtype=torch.float32):
        super().__init__()
        self.ls_init_value = ls_init_value
        self.ln_1 = FusedLayerNorm(d_model, dtype=dtype)
        self.attn = MultiheadAttention(d_model, n_head, dtype=dtype)
        self.ln_2 = FusedLayerNorm(d_model, dtype=dtype)
        self.mlp = _MLP(d_model, int(d_model * mlp_ratio), dtype=dtype)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(d_model, ls_init_value)
            self.ls_2 = LayerScale(d_model, ls_init_value)

    def _ls(self, idx: int, x):
        if self.ls_init_value is None:
            return x
        return (self.ls_1 if idx == 1 else self.ls_2)(x)

    def forward(self, x, attn_mask=None):
        x = x + self._ls(1, self.attn(self.ln_1(x), attn_mask))
        return x + self._ls(2, self.mlp(self.ln_2(x)))

    def streamed(self, stream, delta, attn_mask=None):
        """Pre-LN step over a (stream, delta) residual pair: the pending
        residual add fuses into the next LN's read (``layer_norm_add``).
        The same function as ``forward`` with x = stream + delta."""
        if delta is None:
            s1, y1 = stream, self.ln_1(stream)
        else:
            s1, y1 = self.ln_1(stream, add=delta)
        a = self._ls(1, self.attn(y1, attn_mask))
        s2, y2 = self.ln_2(s1, add=a)
        return s2, self._ls(2, self.mlp(y2))


class Transformer(nn.Module):
    """The pre-LN blocks as one streamed loop: each block's residual add is
    fused into the next block's first LayerNorm.  With ``remat`` under
    autograd each streamed step's activations are recomputed in the backward
    pass (``torch.utils.checkpoint``), so the result and the kernels launched
    are those of the plain loop."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, ls_init_value, dtype)
            for _ in range(layers))

    def forward(self, x, attn_mask=None):
        remat = self.remat and torch.is_grad_enabled()
        stream, delta = x, None
        for blk in self.resblocks:
            if remat:
                stream, delta = checkpoint(blk.streamed, stream, delta, attn_mask,
                                           use_reentrant=False)
            else:
                stream, delta = blk.streamed(stream, delta, attn_mask)
        return stream if delta is None else stream + delta


def _patchify(x: torch.Tensor, p: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, hh*ww, C*sh*sw), channel-major feature order."""
    b, hh_sh, ww_sw, c = x.shape
    hh, ww = hh_sh // p[0], ww_sw // p[1]
    x = x.reshape(b, hh, p[0], ww, p[1], c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, hh * ww, c * p[0] * p[1])


def _unpatchify(x: torch.Tensor, grid: Tuple[int, int], p: Tuple[int, int], c: int):
    """Inverse of _patchify: (B, L, c*sh*sw) -> (B, H, W, c)."""
    b = x.shape[0]
    x = x.reshape(b, grid[0], grid[1], c, p[0], p[1]).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, grid[0] * p[0], grid[1] * p[1], c)


def _check_knobs(act_layer: str, norm_layer: str) -> None:
    if act_layer.lower() != "gelu" or norm_layer.lower() != "layer_norm":
        raise ValueError(f"unsupported act_layer {act_layer!r} / norm_layer {norm_layer!r}")


def _mask_block(grid: Tuple[int, int], mask_block_size: int) -> int:
    return grid[0] * grid[1] if mask_block_size <= 0 else mask_block_size


class TransformerEncoder(nn.Module):
    """(B, H, W, 3) image -> (B, L, 2*z_channels or z_channels) tokens."""

    def __init__(self, *, image_size: int, patch_size: int, width: int, layers: int,
                 heads: int, mlp_ratio: float, double_z: bool, z_channels: int,
                 ls_init_value: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 ln_pre: bool = True, ln_post: bool = True, act_layer: str = "gelu",
                 norm_layer: str = "layer_norm", mask_type: Optional[str] = "none",
                 mask_block_size: int = -1, remat: bool = False, dtype=torch.float32):
        super().__init__()
        del drop_rate, attn_drop_rate, drop_path_rate, ln_post  # ln_post is always on here
        _check_knobs(act_layer, norm_layer)
        self.dtype = as_torch_dtype(dtype)
        self.z_channels = z_channels
        self.patch = (patch_size, patch_size)
        self.grid_size = (image_size // patch_size, image_size // patch_size)
        self.mask_type = mask_type or "none"
        self.mask_block_size = mask_block_size
        self.conv1 = CastLinear(3 * patch_size * patch_size, width, bias=not ln_pre,
                                dtype=self.dtype)
        self.positional_embedding = nn.Parameter(
            torch.empty(self.grid_size[0] * self.grid_size[1], width))
        self.ln_pre = FusedLayerNorm(width, dtype=self.dtype) if ln_pre else None
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value,
                                       remat=remat, dtype=self.dtype)
        self.ln_post = FusedLayerNorm(width, dtype=self.dtype)
        self.quant_embed = CastLinear(width, 2 * z_channels if double_z else z_channels,
                                      dtype=self.dtype)

    def forward(self, x, train: bool = False):
        """``train`` is accepted as the JAX ViT's; no layer depends on it."""
        del train
        x = self.conv1(_patchify(x, self.patch))
        x = x + self.positional_embedding.to(x.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        mask = get_attention_mask(x.shape[1], self.mask_type,
                                  _mask_block(self.grid_size, self.mask_block_size), x.device)
        x = self.transformer(x, mask)
        return self.quant_embed(self.ln_post(x))

    @staticmethod
    def last_layer_path() -> Tuple[str, ...]:
        """The encoder's final projection (``quant_embed``'s weight): the vf
        adaptive weight's target, as the UNet encoder's ``conv_out``."""
        return ("quant_embed", "weight")


class TransformerDecoder(nn.Module):
    """(B, L, z_channels) tokens -> (B, H, W, 3) image."""

    def __init__(self, *, image_size: int, patch_size: int, width: int, layers: int,
                 heads: int, mlp_ratio: float, double_z: bool, z_channels: int,
                 ls_init_value: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 ln_pre: bool = True, ln_post: bool = True, act_layer: str = "gelu",
                 norm_layer: str = "layer_norm", use_ffn_output: bool = True,
                 dim_ffn_output: int = 3072, logit_laplace: bool = False,
                 mask_type: Optional[str] = "none", mask_block_size: int = -1,
                 remat: bool = False, dtype=torch.float32):
        super().__init__()
        del double_z, drop_rate, attn_drop_rate, drop_path_rate  # accepted for config aliasing
        _check_knobs(act_layer, norm_layer)
        self.dtype = as_torch_dtype(dtype)
        self.patch = (patch_size, patch_size)
        self.grid_size = (image_size // patch_size, image_size // patch_size)
        self.out_channels = 3 * (1 + int(logit_laplace))
        self.mask_type = mask_type or "none"
        self.mask_block_size = mask_block_size
        out_feats = self.out_channels * patch_size * patch_size
        if use_ffn_output:
            self.ffn = nn.Sequential(CastLinear(width, dim_ffn_output, dtype=self.dtype),
                                     nn.Tanh())
            self.conv_out = CastLinear(dim_ffn_output, out_feats, dtype=self.dtype)
        else:
            self.ffn = None
            self.conv_out = CastLinear(width, out_feats, dtype=self.dtype)
        self.positional_embedding = nn.Parameter(
            torch.empty(self.grid_size[0] * self.grid_size[1], width))
        self.ln_pre = FusedLayerNorm(width, dtype=self.dtype) if ln_pre else None
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value,
                                       remat=remat, dtype=self.dtype)
        self.ln_post = FusedLayerNorm(width, dtype=self.dtype) if ln_post else None
        self.post_quant_embed = CastLinear(z_channels, width, dtype=self.dtype)

    def _trunk(self, x):
        x = self.post_quant_embed(x)
        x = x + self.positional_embedding.to(x.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        mask = get_attention_mask(x.shape[1], self.mask_type,
                                  _mask_block(self.grid_size, self.mask_block_size), x.device)
        x = self.transformer(x, mask)
        if self.ln_post is not None:
            x = self.ln_post(x)
        if self.ffn is not None:
            x = self.ffn(x)
        return x

    def forward(self, x, train: bool = False):
        """``train`` is accepted as the JAX ViT's; no layer depends on it."""
        return self.last_layer(self._trunk(x), train)

    def pre_last_layer(self, x, train: bool = False):
        """The trunk up to (excluding) conv_out."""
        del train
        return self._trunk(x)

    def last_layer(self, x, train: bool = False):
        """conv_out + unpatchify; pre_last_layer then last_layer is forward."""
        del train
        return _unpatchify(self.conv_out(x), self.grid_size, self.patch, self.out_channels)

    @staticmethod
    def last_layer_path() -> Tuple[str, ...]:
        """The weight the adaptive GAN weight differentiates against (the
        reference decoder's ``get_last_layer``: conv_out's weight)."""
        return ("conv_out", "weight")
