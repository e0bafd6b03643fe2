"""Config registry: YAML configs naming class paths, resolved onto port classes.

A copy of the JAX package's loader (multi-base deep merge, ``${a.b.c}``
interpolation, ``key=value`` dotlist overrides) with one difference: targets
never import the JAX package.  The shipped YAMLs name
``vqvae_from_gaussian_vae_tpu.*`` classes and the reference's ``pit.*``
classes; both spellings map through ``_PORT_TARGETS`` onto this package.  A
JAX-package or reference target without a port counterpart raises
``NotImplementedError``.
"""

from __future__ import annotations

import ast
import copy
import importlib
import re
from typing import Any, Iterable, Mapping

import torch
import yaml

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")

_PKG = "vqvae_from_gaussian_vae_tpu_torch"

# (JAX-package path, reference pit path) -> port path
_PORT_TARGETS = {}
for _jax_path, _pit_path, _port_path in (
    ("models.autoencoder.AutoencodingEngine", "pit.models.autoencoder.AutoencodingEngine",
     "models.autoencoder.AutoencodingEngine"),
    ("models.unet.Encoder", "pit.modules.unet.Encoder", "models.unet.Encoder"),
    ("models.unet.Decoder", "pit.modules.unet.Decoder", "models.unet.Decoder"),
    ("models.vit.TransformerEncoder", "pit.modules.vit.TransformerEncoder",
     "models.vit.TransformerEncoder"),
    ("models.vit.TransformerDecoder", "pit.modules.vit.TransformerDecoder",
     "models.vit.TransformerDecoder"),
    ("quantization.gaussian.GaussianQuantRegularizer",
     "pit.quantization.gaussian.GaussianQuantRegularizer",
     "quantization.gaussian.GaussianQuantRegularizer"),
    ("quantization.gaussian.GaussianQuantRegularizer2",
     "pit.quantization.gaussian.GaussianQuantRegularizer2",
     "quantization.gaussian.GaussianQuantRegularizer2"),
    ("quantization.gaussian.GaussianRegularizer", "pit.quantization.gaussian.GaussianRegularizer",
     "quantization.gaussian.GaussianRegularizer"),
    ("quantization.gaussian.IdentityRegularizer", "pit.quantization.gaussian.IdentityRegularizer",
     "quantization.gaussian.IdentityRegularizer"),
    ("quantization.vq.VQQuantizer", "pit.quantization.vq.VQQuantizer",
     "quantization.vq.VQQuantizer"),
    ("quantization.fsq.FSQQuantizer", "pit.quantization.fsq.FSQQuantizer",
     "quantization.fsq.FSQQuantizer"),
    ("quantization.lfq.LFQQuantizer", "pit.quantization.lfq.LFQQuantizer",
     "quantization.lfq.LFQQuantizer"),
    ("quantization.bsq.BSQQuantizer", "pit.quantization.bsq.BSQQuantizer",
     "quantization.bsq.BSQQuantizer"),
    # the vf branch's frozen trunk: the reference's foundation_models module
    ("models.foundation.FoundationViT", None, "models.foundation.FoundationViT"),
    ("models.foundation.aux_foundation_model", "pit.models.foundation_models.aux_foundation_model",
     "models.foundation.aux_foundation_model"),
    ("models.foundation.DINOEncoder", "pit.models.foundation_models.DINOEncoder",
     "models.foundation.DINOEncoder"),
    ("losses.discriminator_loss.GeneralLPIPSWithDiscriminator",
     "pit.modules.losses.discriminator_loss.GeneralLPIPSWithDiscriminator",
     "losses.discriminator_loss.GeneralLPIPSWithDiscriminator"),
    ("losses.discriminator.NLayerDiscriminator",
     "pit.modules.lpips.model.model.NLayerDiscriminator",
     "losses.discriminator.NLayerDiscriminator"),
    ("data.dataset.ImageDataModuleFromConfig", "pit.data.ImageDataModuleFromConfig",
     "data.dataset.ImageDataModuleFromConfig"),
    ("data.dataset.SimpleDataset", "pit.data.SimpleDataset", "data.dataset.SimpleDataset"),
    ("data.dataset.StableDataModuleFromConfig",
     "pit.dataset.dataset.StableDataModuleFromConfig",
     "data.dataset.StableDataModuleFromConfig"),
    ("data.video.VideoDataset", None, "data.video.VideoDataset"),
    ("data.video.ImageDataset", None, "data.video.ImageDataset"),
    # the reference's MNIST / CIFAR-10 are Lightning modules that download;
    # like the JAX registry, no pit spelling maps onto these file readers
    ("data.toy.MNISTDataset", None, "data.toy.MNISTDataset"),
    ("data.toy.CIFAR10Dataset", None, "data.toy.CIFAR10Dataset"),
    ("utils.loggers.ImageLogger", "main.ImageLogger", "utils.loggers.ImageLogger"),
    # the post engine and its velocity net; the attention zoo
    ("models.postprocessor.AutoencodingPostEngine",
     "pit.models.postprocessor.AutoencodingPostEngine",
     "models.postprocessor.AutoencodingPostEngine"),
    ("models.hdit.create_hdit_model", "pit.modules.hdit.create_hdit_model",
     "models.hdit.create_hdit_model"),
    ("models.hdit.ImageTransformerDenoiserModelV2",
     "pit.modules.hdit.ImageTransformerDenoiserModelV2",
     "models.hdit.ImageTransformerDenoiserModelV2"),
    *((f"models.attention.{_cls}", f"pit.modules.attention.{_cls}",
       f"models.attention.{_cls}") for _cls in (
        "CrossAttention", "MemoryEfficientCrossAttention", "SelfAttention",
        "SpatialSelfAttention", "GEGLU", "FeedForward", "BasicTransformerBlock",
        "BasicTransformerSingleLayerBlock", "SimpleTransformer", "SpatialTransformer")),
    # the frozen baseline VAEs (the reference's eval wrappers) and HunyuanVAE2D
    *((f"models.third_party.{_cls}", f"pit.models.autoencoder.{_cls}",
       f"models.third_party.{_cls}") for _cls in (
        "AutoencoderKLFLUX", "AutoencoderKLSD3", "AutoencoderKLEQ", "AutoencoderKLHYImage2",
        "AutoencoderKLHYImage3", "AutoencoderKLQwenImage", "AutoencoderKLWAN")),
    ("models.third_party.AutoencoderKLDiffusers", None,
     "models.third_party.AutoencoderKLDiffusers"),
    ("models.hyvae.HunyuanVAE2D", "pit.models.hyvae.HunyuanVAE2D", "models.hyvae.HunyuanVAE2D"),
    ("models.hyvae.Encoder", None, "models.hyvae.Encoder"),
    ("models.hyvae.Decoder", None, "models.hyvae.Decoder"),
    # the WAN video VAE under the Qwen-Image and WAN wrappers
    *((f"models.wan.{_cls}", None, f"models.wan.{_cls}") for _cls in (
        "AutoencoderKLWan", "WanEncoder3d", "WanDecoder3d")),
    # the generative token decoder: FLUX, its ControlNet, the pipeline, the engines
    *((f"models.{_path}", None, f"models.{_path}") for _path in (
        "flux.Flux", "flux.ControlNetFlux", "flux.ImageProjModel",
        "flux_pipeline.FluxPipeline", "flux_pipeline.AutoencodingFluxEngine",
        "flux_pipeline.AutoencodingFluxLoraEngine", "conditioner.HFEmbedder")),
):
    _PORT_TARGETS[f"vqvae_from_gaussian_vae_tpu.{_jax_path}"] = f"{_PKG}.{_port_path}"
    if _pit_path is not None:
        _PORT_TARGETS[_pit_path] = f"{_PKG}.{_port_path}"

# prefixes of targets that belong to the JAX package or the reference; any of
# them not in _PORT_TARGETS is a module the port does not have yet
_UNPORTED_PREFIXES = ("vqvae_from_gaussian_vae_tpu.", "pit.", "main.")


def default(val: Any, d: Any) -> Any:
    """``val`` unless it is None, else ``d`` (called if callable)."""
    if val is not None:
        return val
    return d() if callable(d) else d


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def as_torch_dtype(dtype) -> torch.dtype:
    """A YAML dtype string ("bfloat16", "float32") or a torch dtype -> torch
    dtype: the port's counterpart of the engine's YAML-string -> jnp dtype
    step in the JAX package."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype in _DTYPES:
        return _DTYPES[dtype]
    raise ValueError(f"unknown dtype {dtype!r}")


def resolve_target(target: str) -> str:
    """Map a config target onto an importable port path.

    Raises NotImplementedError for a JAX-package or reference target that
    has no port counterpart.
    """
    if target in _PORT_TARGETS:
        return _PORT_TARGETS[target]
    if target.startswith(_PKG + "."):
        return target
    if target.startswith(_UNPORTED_PREFIXES):
        raise NotImplementedError(
            f"config target {target!r} has no counterpart in {_PKG} yet")
    return target


def get_obj_from_str(string: str) -> Any:
    """Resolve ``pkg.module.ClassName`` (after alias mapping) to the object."""
    module, cls = resolve_target(string).rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def instantiate_from_config(config: Mapping[str, Any], **extra_kwargs: Any) -> Any:
    """Instantiate ``config['target'](**config['params'], **extra_kwargs)``."""
    if "target" not in config:
        if config in ("__is_first_stage__", "__is_unconditional__"):
            return None
        raise KeyError("Expected key `target` to instantiate.")
    cls = get_obj_from_str(config["target"])
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return cls(**params)


# ---------------------------------------------------------------------------
# YAML loading / merging / interpolation


def _deep_merge(base: Any, override: Any) -> Any:
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = _deep_merge(base[k], v) if k in base else v
        return out
    return override


def _select(root: Mapping[str, Any], dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, (list, tuple)):
            node = node[int(part)]
        else:
            node = node[part]
    return node


def _resolve_interp(node: Any, root: Mapping[str, Any], depth: int = 0) -> Any:
    if depth > 16:
        raise RecursionError("config interpolation too deep (cycle?)")
    if isinstance(node, str):
        m = _INTERP_RE.match(node)
        if m:
            return _resolve_interp(_select(root, m.group(1)), root, depth + 1)
        return node
    if isinstance(node, dict):
        return {k: _resolve_interp(v, root, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interp(v, root, depth) for v in node]
    return node


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("null", "none"):
            return None
        return text


def apply_dotlist(cfg: dict, dotlist: Iterable[str]) -> dict:
    """Apply ``a.b.c=value`` overrides."""
    cfg = copy.deepcopy(cfg)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist override must look like key=value, got {item!r}")
        key, value = item.split("=", 1)
        parts = key.lstrip("-").split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return cfg


def load_config(
    bases: Iterable[str] | str,
    dotlist: Iterable[str] = (),
    resolve: bool = True,
) -> dict:
    """Load one or more YAML files, deep-merging left to right, apply dotlist
    overrides, then resolve ``${...}`` interpolations."""
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for path in bases:
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        merged = _deep_merge(merged, cfg)
    if dotlist:
        merged = apply_dotlist(merged, dotlist)
    if resolve:
        merged = _resolve_interp(merged, merged)
    return merged
