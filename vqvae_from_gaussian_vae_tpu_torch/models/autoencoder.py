"""The tokenizer engine.

Port of ``vqvae_from_gaussian_vae_tpu/models/autoencoder.py``:
``EngineModule`` is the ``nn.Module`` (encoder + regularizer + decoder, and
the optional latent standardisation); ``AutoencodingEngine`` is the
config-instantiated object with the public API::

    engine = instantiate_from_config(cfg["model"])   # YAMLs load unchanged
    z, reg_log = engine.encode(x, return_reg_log=True)
    z, indices = engine.quant(x)
    xhat       = engine.dequant(indices)
    xrec       = engine.decode(z)

Images are NHWC in [-1, 1], indices (B, h, w, ng) int32, as in the JAX
package.  The engine runs on the CUDA device unless the caller passes
``device="cpu"``; weights come from ``seed`` (or a checkpoint).  The public
API above runs under ``torch.inference_mode``.  With a ``loss_config`` (and
not ``eval_only``) the engine also builds its loss head (``engine.loss``),
and ``EngineModule`` offers the training pieces the GAN step uses
(``encode(..., train=True, duals=...)``, ``decode_pre_last_layer``,
``decode_last_layer``, ``last_layer_path``; ``parallel/train_step.py``).

The vf alignment branch (``use_vf``: "dinov2", "dinov3" or "mae") adds a
frozen foundation trunk (``models/foundation.py``) and ``linear_proj``, a
1x1 conv: with ``reverse_proj`` z is resized to the trunk's feature grid
and projected to its width, else the features are projected to z's
channels.  The forward then puts ``aux_feature`` and ``zp`` in the reg log
for the loss's vf terms.  The resize is ``jax.image.resize``'s antialiased
bilinear (``resize_bilinear``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.utils.config import instantiate_from_config

# trainer keys: kept on the engine for the trainer (parallel/trainer.py),
# with the JAX engine's defaults
_TRAINING_KEYS = {
    "optimizer_config": None, "lr_g_factor": 1.0, "trainable_ae_params": None,
    "ae_optimizer_args": None, "trainable_disc_params": None, "disc_optimizer_args": None,
    "disc_start_iter": 0, "diff_boost_factor": 3.0, "monitor": None,
}


def resize_bilinear(z: torch.Tensor, size) -> torch.Tensor:
    """NHWC z -> (B, size[0], size[1], C) float32: ``jax.image.resize(...,
    "bilinear")``, which antialiases a downsample; torch's antialiased
    bilinear (half-pixel centres) is the same filter."""
    out = F.interpolate(z.float().permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class EngineModule(nn.Module):
    """encode -> regularize -> decode, all tensors NHWC."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, regularization: nn.Module,
                 latent_stats: bool = False, clamp_range: Optional[Sequence[float]] = None,
                 foundation: Optional[nn.Module] = None, reverse_proj: bool = False,
                 vf_dim: Optional[int] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.regularization = regularization
        self.latent_stats = latent_stats
        self.clamp_range = tuple(clamp_range) if clamp_range is not None else None
        if latent_stats:
            zc = encoder.z_channels
            # the reference's (1, C, 1, 1) layout, applied over NHWC channels
            self.latent_mean = nn.Parameter(torch.zeros(1, zc, 1, 1), requires_grad=False)
            self.latent_std = nn.Parameter(torch.ones(1, zc, 1, 1), requires_grad=False)
        self.foundation = foundation
        self.reverse_proj = reverse_proj
        if foundation is not None:
            zc = encoder.z_channels
            # a 1x1 conv: z -> the features' width without bias, or back
            self.linear_proj = (nn.Conv2d(zc, vf_dim, 1, bias=False) if reverse_proj
                                else nn.Conv2d(vf_dim, zc, 1, bias=True))

    def _standardize(self, z):
        if self.latent_stats:
            return (z - self.latent_mean.reshape(1, 1, 1, -1)) / self.latent_std.reshape(1, 1, 1, -1)
        return z

    def _unstandardize(self, z):
        if self.latent_stats:
            return z * self.latent_std.reshape(1, 1, 1, -1) + self.latent_mean.reshape(1, 1, 1, -1)
        return z

    def _clamp(self, x):
        if self.clamp_range is not None:
            return torch.clamp(x, self.clamp_range[0], self.clamp_range[1])
        return x

    def encode(self, x, return_reg_log: bool = False, unregularized: bool = False,
               train: bool = False, duals=None, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None, noise_rows=None):
        """``train=True`` runs the encoder's training path and takes the
        regularizer's train branch (the reparameterised sample and the KL
        loss, weighted by ``duals``).  ``noise_rows`` (rank, world): this
        rank's rows of the joined batch's eps (``quantization/gaussian.py``)."""
        z = self.encoder(x, train=train)
        if unregularized:
            return z, {}
        z, reg_log = self.regularization(z, train=train, duals=duals, generator=generator,
                                         eps=eps, noise_rows=noise_rows)
        z = self._standardize(z)
        return (z, reg_log) if return_reg_log else z

    def decode(self, z, train: bool = False):
        return self.decoder(self._unstandardize(z), train=train)

    def decode_pre_last_layer(self, z, train: bool = False):
        """The decoder up to (excluding) its last layer."""
        return self.decoder.pre_last_layer(self._unstandardize(z), train=train)

    def decode_last_layer(self, h, train: bool = False):
        """The decoder's last layer and the clamp: decode_pre_last_layer then
        decode_last_layer is decode with the clamp, so the adaptive GAN
        weight differentiates the graph the loss sees."""
        return self._clamp(self.decoder.last_layer(h, train=train))

    @property
    def last_layer_path(self) -> str:
        """The name of the weight the adaptive GAN weight differentiates."""
        return ".".join(("decoder",) + tuple(self.decoder.last_layer_path()))

    def _linear_proj(self, t):
        p = self.linear_proj
        return F.linear(t, p.weight.flatten(1), p.bias)

    def vf_features(self, x, z):
        """(aux_feature, zp) of the vf branch: the frozen trunk's features
        (no gradient) and z resized to their grid, one of them projected."""
        with torch.no_grad():
            aux = self.foundation(x)
        zp = resize_bilinear(z, aux.shape[1:3])
        if self.reverse_proj:
            return aux, self._linear_proj(zp)
        return self._linear_proj(aux), zp

    def dequant(self, indices):
        # as the reference: dequant routes through decode (un-standardising)
        return self._clamp(self.decode(self.regularization.dequant(indices)))

    def forward(self, x, train: bool = False, duals=None,
                generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        z, reg_log = self.encode(x, return_reg_log=True, train=train, duals=duals,
                                 generator=generator, eps=eps)
        dec = self.decode(z, train=train)
        if self.foundation is not None:
            aux, zp = self.vf_features(x, z)
            reg_log = {**reg_log, "aux_feature": aux, "zp": zp}
        return z, self._clamp(dec), reg_log


def resolve_device(device=None) -> torch.device:
    """None means the CUDA device; without one, only an explicit "cpu" runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "port on the CPU")
        device = "cuda"
    return torch.device(device)


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded weights: conv kernels (O, I, kh, kw) and (O, I, kt, kh, kw),
    Linear weights (O, I) and the attention's ``in_proj_weight`` (3C, C)
    N(0, 1/fan_in) (the lecun-normal scale of the JAX package's default
    init); the ViT's
    positional embedding N(0, 0.02^2), as its JAX init; biases 0; GroupNorm
    and LayerNorm affine (1, 0); LayerScale ``gamma`` keeps its init value."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("latent_mean", "latent_std", "gamma"):
                continue
            if leaf in ("positional_embedding", "pos_embed", "cls_token"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name.endswith("embedding.weight"):  # VQ's codebook: uniform(-1/n, 1/n)
                p.uniform_(-1.0 / p.shape[0], 1.0 / p.shape[0], generator=gen)
            elif p.dim() in (2, 4, 5):
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
            elif leaf.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def init_loss_weights(loss: nn.Module, seed: int) -> None:
    """Seeded loss-head weights, as the JAX package initialises them: the
    LPIPS convs and heads N(0, 1/fan_in) with zero biases, the
    discriminator's convs N(0, 0.02^2) with zero biases (the reference's
    weights_init), ActNorm (loc 0, scale 1) until its data init, BatchNorm
    (1, 0); ``logvar`` keeps its ``logvar_init``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in loss.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "logvar" or leaf in ("loc", "scale"):
                continue
            if p.dim() == 4:
                std = 0.02 if name.startswith("discriminator.") else p[0].numel() ** -0.5
                p.copy_(torch.randn(p.shape, generator=gen) * std)
            elif leaf == "bias":
                p.zero_()
            else:
                p.fill_(1.0)


class AutoencodingEngine:
    """Config-driven tokenizer."""

    def __init__(self, *, encoder_config: Dict, decoder_config: Dict,
                 regularizer_config: Dict, input_key: str = "img",
                 loss_config: Optional[Dict] = None, eval_only: bool = False,
                 ckpt_path: Optional[str] = None, ckpt_engine: Optional[str] = None,
                 additional_decode_keys: Optional[Sequence[str]] = None,
                 use_vf: Optional[str] = None, reverse_proj: bool = False,
                 vf_weights_path: Optional[str] = None,
                 clamp_range: Optional[Sequence[float]] = None, latent_stats: bool = False,
                 seed: int = 0, device=None, **kwargs):
        unknown = sorted(set(kwargs) - set(_TRAINING_KEYS))
        if unknown:
            raise TypeError(f"AutoencodingEngine got unsupported kwargs: {unknown}")
        if additional_decode_keys:
            raise NotImplementedError("additional_decode_keys is not supported")
        if ckpt_path is not None and ckpt_engine is not None:
            raise ValueError("set ckpt_path or ckpt_engine, not both")
        self.input_key = input_key
        for key, value in _TRAINING_KEYS.items():
            setattr(self, key, kwargs.get(key, value))
        self.learning_rate: Optional[float] = None  # set by the trainer
        self.device = resolve_device(device)
        self.loss = (instantiate_from_config(loss_config)
                     if loss_config and not eval_only else None)
        self.encoder = instantiate_from_config(encoder_config)
        self.decoder = instantiate_from_config(decoder_config)
        self.regularization = instantiate_from_config(regularizer_config)
        self.use_vf = use_vf
        self.foundation_model = None
        if use_vf is not None:
            from vqvae_from_gaussian_vae_tpu_torch.models.foundation import aux_foundation_model

            p = encoder_config.get("params", {})
            self.foundation_model = aux_foundation_model(
                use_vf, weights_path=vf_weights_path,
                image_size=p.get("resolution", p.get("image_size", 256)))
        fm = self.foundation_model
        self.module = EngineModule(self.encoder, self.decoder, self.regularization,
                                   latent_stats=latent_stats, clamp_range=clamp_range,
                                   foundation=None if fm is None else fm.module,
                                   reverse_proj=reverse_proj,
                                   vf_dim=None if fm is None else fm.feature_dim)
        self.module.eval()
        self.init_params(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        ckpt = ckpt_path if ckpt_path is not None else ckpt_engine
        if ckpt is not None:
            self.load_checkpoint(ckpt)

    # ------------------------------------------------------------- params

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights (see ``init_weights``), on the engine's device."""
        self.module.to("cpu")
        init_weights(self.module, seed)
        if self.foundation_model is not None:
            self.foundation_model.load_weights()
        self.module.to(self.device, memory_format=torch.channels_last)
        if self.loss is not None:
            self.loss.to("cpu")
            init_loss_weights(self.loss, seed + 1)
            self.loss.load_pretrained()
            self.loss.to(self.device)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        return self.module.load_state_dict(state_dict, strict=strict)

    def load_checkpoint(self, path: str, ignore_keys: Sequence[str] = ()):
        """Load a reference ``pit`` .ckpt (Lightning), a raw state_dict, or
        a checkpoint directory of the port's trainer (its engine weights);
        strict=False semantics.  Returns (missing, unexpected) keys.

        Files are read with ``weights_only=True``: a checkpoint is data and
        loading one runs no code it carries.  A Lightning .ckpt holds plain
        containers, tensors, numbers and strings, which load; one that
        pickles another class (a config object in ``hyper_parameters``, say)
        is refused with torch's error, which names the class.  Re-save its
        ``state_dict`` alone to load it.  (The JAX package's loader reads
        with ``weights_only=False``.)"""
        if os.path.isdir(path):
            from vqvae_from_gaussian_vae_tpu_torch.parallel.trainer import read_checkpoint

            sd = read_checkpoint(path)["engine"]
        else:
            blob = torch.load(path, map_location="cpu", weights_only=True)
            sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        keep = ("encoder.", "decoder.", "regularization.", "latent_mean", "latent_std")
        sd = {k: v for k, v in sd.items()
              if k.startswith(keep) and not any(k.startswith(i) for i in ignore_keys)}
        result = self.module.load_state_dict(sd, strict=False)
        return list(result.missing_keys), list(result.unexpected_keys)

    def save_params(self, path: str) -> None:
        """The engine's weights as one state_dict file (``load_checkpoint``
        reads it back)."""
        torch.save(self.module.state_dict(), path)

    def get_last_layer(self) -> torch.Tensor:
        """The decoder's last-layer weight, which the adaptive GAN weight
        differentiates."""
        return self.module.get_parameter(self.module.last_layer_path)

    # ------------------------------------------------------------- API

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def encode(self, x, return_reg_log: bool = False, unregularized: bool = False,
               eps: Optional[torch.Tensor] = None):
        return self.module.encode(self._input(x), return_reg_log=return_reg_log,
                                  unregularized=unregularized, generator=self.generator,
                                  eps=eps)

    @torch.inference_mode()
    def decode(self, z):
        return self.module.decode(self._input(z))

    def quant(self, x):
        """x -> (z, indices)."""
        z, reg_log = self.encode(x, return_reg_log=True)
        return z, reg_log["indices"]

    @torch.inference_mode()
    def dequant(self, indices):
        """indices -> image."""
        return self.module.dequant(self._input(indices))

    @torch.inference_mode()
    def forward(self, x, eps: Optional[torch.Tensor] = None):
        """x -> (z, xrec, reg_log)."""
        return self.module(self._input(x), generator=self.generator, eps=eps)

    __call__ = forward

    def log_images(self, batch: Dict, **kwargs) -> Dict[str, torch.Tensor]:
        """Inputs, reconstructions (the eval forward, GQ search), the
        difference and the boosted difference, each NHWC in [-1, 1]."""
        x = self._input(batch[self.input_key]).float()
        _, xrec, _ = self.forward(x)
        xrec = xrec.float()
        diff = torch.clamp(0.5 * torch.abs(torch.clamp(xrec, -1.0, 1.0) - x), 0.0, 1.0)
        return {"inputs": x, "reconstructions": xrec, "diff": 2.0 * diff - 1.0,
                "diff_boost": 2.0 * torch.clamp(self.diff_boost_factor * diff, 0.0, 1.0) - 1.0}
