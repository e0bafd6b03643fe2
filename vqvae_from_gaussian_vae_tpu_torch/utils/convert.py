"""Carry JAX-package weights into the port.

``state_dict_from_jax(params)`` maps the JAX engine's parameter tree (nested
dicts of arrays) onto the port's ``pit``-named state_dict:

  * path ``encoder / down_0 / block_1 / conv1 / kernel`` ->
    key ``encoder.down.0.block.1.conv1.weight``: a ``<list>_<i>`` segment
    is list element i, except the mid block's own ``block_1`` / ``block_2``;
    the ViT's ``resblocks_<i>`` and the decoder's ``ffn_<i>`` likewise
  * conv kernel HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw)
  * Dense kernel (I, O) -> Linear weight (O, I)
  * attention ``in_proj / {kernel (C, 3C), bias}`` -> torch's
    ``in_proj_weight`` (3C, C) and ``in_proj_bias``
  * GroupNorm and LayerNorm ``scale`` -> ``weight``
  * latent statistics (1, 1, 1, C) -> the reference's (1, C, 1, 1)
  * ``positional_embedding`` and LayerScale ``gamma`` unchanged
  * the VQ codebook ``regularization / embedding`` -> the ``nn.Embedding``'s
    ``regularization.embedding.weight``
  * the vf branch: ``foundation / patch_embed`` (a conv), ``cls_token``,
    ``pos_embed`` (unchanged), ``blocks_<i> / ...`` (the ViT block's names)
    and ``norm``; ``linear_proj`` (a 1x1 conv)
  * the UNet's linear attention ``attn_<i> / to_qkv``, ``to_out`` (Dense)
  * the attention zoo (``models/attention.py``): ``to_out_0``, ``net_<i>``,
    ``layers_<i>`` and ``transformer_blocks_<i>`` are list elements
  * the post engine's HDiT (``models/hdit.py``, the tree of its
    ``poster_params``): its module names are the flax names, so
    ``down_0_block_1 / attn_norm / mod / kernel`` ->
    ``down_0_block_1.attn_norm.mod.weight``, ``FourierFeatures_0 / freqs``
    and ``skip_gate_0`` unchanged, ``merge_0 / Dense_0`` a Linear

  * flux (``models/flux.py``: the trees of ``Flux``, ``ControlNetFlux`` and
    ``ImageProjModel``): ``double_blocks_<i>``, ``single_blocks_<i>``,
    ``controlnet_blocks_<i>`` and ``input_hint_block_<i>`` are list
    elements; ``img_attn_qkv`` -> ``img_attn.qkv`` (``proj``, ``norm`` and
    the txt stream likewise), ``img_mlp_0`` -> ``img_mlp.0``,
    ``adaLN_modulation_1`` -> ``adaLN_modulation.1``; the LoRA deltas
    ``img_qkv_lora``, ``img_proj_lora`` -> ``processor.qkv_lora1``,
    ``processor.proj_lora1`` (``txt_*`` -> ``*_lora2``; the single block's
    ``qkv_lora``, ``proj_lora`` -> ``processor.qkv_lora``, ...) and the
    IP-adapter's ``ip_adapter_*_proj`` -> ``processor.ip_adapter_*_proj``;
    RMSNorm's ``query_norm / scale`` and ``key_norm / scale`` keep ``scale``
  * HunyuanVAE2D (``models/hyvae.py``, the tree under ``encoder`` and
    ``decoder``): ``down_<i>_block_<j>`` -> ``down.<i>.block.<j>``,
    ``down_<i>_downsample`` -> ``down.<i>.downsample`` (``up`` likewise),
    ``mid_block_1`` / ``mid_attn_1`` -> ``mid.block_1`` / ``mid.attn_1``
  * the third-party wrappers: the UNet's names under ``encoder`` and
    ``decoder`` (``AutoencoderKLDiffusers``), HunyuanVAE2D's (the
    HunyuanImage wrappers' ``model``)

and the loss head's tree (the JAX train state's ``loss_params``) onto the
port's loss state_dict: ``perceptual_loss / net / features_N`` ->
``perceptual_loss.net.features.N``, ``lin{k} / model_1`` ->
``lin{k}.model.1``, ``discriminator / main_i`` -> ``discriminator.main.i``
(ActNorm ``loc`` / ``scale`` (1, 1, 1, C) -> the reference's (1, C, 1, 1)),
and the scalar ``logvar``.

The reverse direction needs no code here: the JAX package's
``utils/torch_convert.py:convert_state_dict`` loads a port state_dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LIST_SEGMENT = re.compile(
    r"^(down|up|block|blocks|attn|resblocks|ffn|features|main|model|to_out|net|layers"
    r"|transformer_blocks)_(\d+)$")
_NCHW_STATS = ("latent_mean", "latent_std", "loc", "scale")  # (1, 1, 1, C) -> (1, C, 1, 1)
# flux's flat flax names -> the reference's module paths
_RENAMES = tuple((re.compile(a), b) for a, b in (
    (r"^(double_blocks|single_blocks|controlnet_blocks|input_hint_block)_(\d+)$", r"\1.\2"),
    (r"^(img|txt)_attn_(qkv|proj|norm)$", r"\1_attn.\2"),
    (r"^(img|txt)_mlp_(\d+)$", r"\1_mlp.\2"),
    (r"^img_(qkv|proj)_lora$", r"processor.\1_lora1"),
    (r"^txt_(qkv|proj)_lora$", r"processor.\1_lora2"),
    (r"^(qkv|proj)_lora$", r"processor.\1_lora"),
    (r"^(ip_adapter_\w+)$", r"processor.\1"),
    (r"^adaLN_modulation_(\d+)$", r"adaLN_modulation.\1"),
))
# HunyuanVAE2D's, under a root ``encoder`` or ``decoder`` (HDiT's tree keeps
# its own ``down_<i>_block_<j>`` names)
_HYVAE_RENAMES = tuple((re.compile(a), b) for a, b in (
    (r"^(down|up)_(\d+)_block_(\d+)$", r"\1.\2.block.\3"),
    (r"^(down|up)_(\d+)_(downsample|upsample)$", r"\1.\2.\3"),
    (r"^mid_(block|attn)_(\d+)$", r"mid.\1_\2"),
))
_KEEP_SCALE = ("query_norm", "key_norm")  # flux's RMSNorm names its weight ``scale``


def _rename(seg: str, renames) -> list:
    for pattern, repl in renames:
        if pattern.match(seg):
            return pattern.sub(repl, seg).split(".")
    return [seg]


def _key(path, keep_leaf: bool = False) -> str:
    out = []
    renames = _RENAMES + (_HYVAE_RENAMES if path[0] in ("encoder", "decoder") else ())
    for i, seg in enumerate(path[:-1]):
        m = _LIST_SEGMENT.match(seg)
        parent = path[i - 1] if i else ""
        if m and not (parent == "mid" and m.group(1) == "block"):
            out += [m.group(1), m.group(2)]
        else:
            out += _rename(seg, renames)
    leaf = path[-1]
    if leaf == "scale" and out and out[-1] in _KEEP_SCALE:
        keep_leaf = True
    if leaf == "embedding":  # a flax table param -> nn.Embedding's weight
        return ".".join(out + [leaf, "weight"])
    if out and out[-1] == "in_proj":  # nn.MultiheadAttention's packed projection
        out[-1] = {"kernel": "in_proj_weight", "bias": "in_proj_bias"}[leaf]
    else:
        out.append(leaf if keep_leaf else {"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(out)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX engine (or loss-head) param tree (nested mappings of numpy or
    array leaves) -> port state_dict."""
    sd = {}
    for path, value in _flatten(params):
        v = np.asarray(value, dtype=np.float32)
        stats = path[-1] in _NCHW_STATS and v.ndim == 4  # not LayerNorm's 1-D scale
        if stats:
            v = v.transpose(0, 3, 1, 2)
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2 and path[-1] == "kernel":
            v = v.T
        sd[_key(path, keep_leaf=stats)] = torch.tensor(v)  # a copy: the source may be read-only
    return sd
