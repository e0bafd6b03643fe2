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
The vf branch is not ported: ``use_vf`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.utils.config import instantiate_from_config

# trainer keys: accepted so training YAMLs load, unused until the trainer is
# ported (the optimizer knobs are make_optimizers' arguments)
_TRAINING_KEYS = (
    "optimizer_config", "lr_g_factor", "trainable_ae_params", "ae_optimizer_args",
    "trainable_disc_params", "disc_optimizer_args", "disc_start_iter",
    "diff_boost_factor", "monitor",
)


class EngineModule(nn.Module):
    """encode -> regularize -> decode, all tensors NHWC."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, regularization: nn.Module,
                 latent_stats: bool = False, clamp_range: Optional[Sequence[float]] = None):
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
               eps: Optional[torch.Tensor] = None):
        """``train=True`` runs the encoder's training path and takes the
        regularizer's train branch (the reparameterised sample and the KL
        loss, weighted by ``duals``)."""
        z = self.encoder(x, train=train)
        if unregularized:
            return z, {}
        z, reg_log = self.regularization(z, train=train, duals=duals, generator=generator,
                                         eps=eps)
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

    def dequant(self, indices):
        # as the reference: dequant routes through decode (un-standardising)
        return self._clamp(self.decode(self.regularization.dequant(indices)))

    def forward(self, x, train: bool = False, duals=None,
                generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        z, reg_log = self.encode(x, return_reg_log=True, train=train, duals=duals,
                                 generator=generator, eps=eps)
        return z, self._clamp(self.decode(z, train=train)), reg_log


def resolve_device(device=None) -> torch.device:
    """None means the CUDA device; without one, only an explicit "cpu" runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "port on the CPU")
        device = "cuda"
    return torch.device(device)


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded weights: conv kernels (O, I, kh, kw), Linear weights (O, I)
    and the attention's ``in_proj_weight`` (3C, C) N(0, 1/fan_in) (the
    lecun-normal scale of the JAX package's default init); the ViT's
    positional embedding N(0, 0.02^2), as its JAX init; biases 0; GroupNorm
    and LayerNorm affine (1, 0); LayerScale ``gamma`` keeps its init value."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("latent_mean", "latent_std", "gamma"):
                continue
            if leaf == "positional_embedding":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif p.dim() in (2, 4):
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
                 clamp_range: Optional[Sequence[float]] = None, latent_stats: bool = False,
                 seed: int = 0, device=None, **kwargs):
        unknown = sorted(set(kwargs) - set(_TRAINING_KEYS))
        if unknown:
            raise TypeError(f"AutoencodingEngine got unsupported kwargs: {unknown}")
        if use_vf is not None or reverse_proj:
            raise NotImplementedError("the vf alignment branch is not ported yet")
        if additional_decode_keys:
            raise NotImplementedError("additional_decode_keys is not supported")
        if ckpt_path is not None and ckpt_engine is not None:
            raise ValueError("set ckpt_path or ckpt_engine, not both")
        del input_key  # the data pipeline's batch key; no data module is ported yet
        self.device = resolve_device(device)
        self.loss = (instantiate_from_config(loss_config)
                     if loss_config and not eval_only else None)
        self.encoder = instantiate_from_config(encoder_config)
        self.decoder = instantiate_from_config(decoder_config)
        self.regularization = instantiate_from_config(regularizer_config)
        self.module = EngineModule(self.encoder, self.decoder, self.regularization,
                                   latent_stats=latent_stats, clamp_range=clamp_range)
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
        """Load a reference ``pit`` .ckpt (Lightning) or a raw state_dict;
        strict=False semantics.  Returns (missing, unexpected) keys."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        keep = ("encoder.", "decoder.", "latent_mean", "latent_std")
        sd = {k: v for k, v in sd.items()
              if k.startswith(keep) and not any(k.startswith(i) for i in ignore_keys)}
        result = self.module.load_state_dict(sd, strict=False)
        return list(result.missing_keys), list(result.unexpected_keys)

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
