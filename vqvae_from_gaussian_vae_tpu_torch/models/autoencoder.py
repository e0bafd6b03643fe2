"""The tokenizer engine, inference path.

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
``device="cpu"``; weights come from ``seed`` (or a checkpoint).  Training,
the loss and the vf branch are not ported: a loss config is accepted only
with ``eval_only=True`` or as None, and ``use_vf`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.utils.config import instantiate_from_config

# training-only config keys: accepted so training YAMLs load, unused at inference
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
               generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        z = self.encoder(x)
        if unregularized:
            return z, {}
        z, reg_log = self.regularization(z, generator=generator, eps=eps)
        z = self._standardize(z)
        return (z, reg_log) if return_reg_log else z

    def decode(self, z):
        return self.decoder(self._unstandardize(z))

    def dequant(self, indices):
        # as the reference: dequant routes through decode (un-standardising)
        return self._clamp(self.decode(self.regularization.dequant(indices)))

    def forward(self, x, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        z, reg_log = self.encode(x, return_reg_log=True, generator=generator, eps=eps)
        return z, self._clamp(self.decode(z)), reg_log


def resolve_device(device=None) -> torch.device:
    """None means the CUDA device; without one, only an explicit "cpu" runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "port on the CPU")
        device = "cuda"
    return torch.device(device)


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded weights: conv kernels N(0, 1/fan_in) (the lecun-normal scale of
    the JAX package's default init), biases 0, GroupNorm affine (1, 0)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("latent_mean") or name.endswith("latent_std"):
                continue
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


class AutoencodingEngine:
    """Config-driven tokenizer (inference)."""

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
        if loss_config and not eval_only:
            # no loss is ported yet: this raises NotImplementedError naming it
            instantiate_from_config(loss_config)
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
