"""Frozen third-party VAEs: the paper's comparison points, evaluated through
the tokenizer's encode / decode protocol.

Port of ``vqvae_from_gaussian_vae_tpu/models/third_party.py``.  Every
wrapper offers ``encode(x, return_reg_log=False, unregularized=False) ->
(z, {})`` (a posterior sample) and ``decode(z) -> image``, NHWC in [-1, 1]
on its device, under ``torch.inference_mode``; the port's ``eval.py`` runs
them in protocol mode (no indices, no codebook histogram).  The posterior's
noise comes from the wrapper's seeded ``torch.Generator`` (the JAX package
splits a ``jax.random`` key), or is injected as ``eps``.

The weights are the port's own modules at the published widths: FLUX, SD3
and EQ are diffusers ``AutoencoderKL`` layouts on the port's UNet
``Encoder`` / ``Decoder`` (``AutoencoderKLDiffusers``), HunyuanImage-2 and
-3 are ``HunyuanVAE2D`` (``models/hyvae.py``).  Nothing downloads: pass
``ckpt_path`` (a converted state_dict), else the weights are seeded and a
warning says so.  The runs are on the CUDA device unless the caller passes
``device="cpu"``.  ``AutoencoderKLQwenImage`` and ``AutoencoderKLWAN`` sit
on the WAN video VAE, which the port does not have yet (ROADMAP.md queue
A): they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import init_weights, resolve_device
from vqvae_from_gaussian_vae_tpu_torch.models.hyvae import (
    DiagonalGaussianDistribution, HunyuanVAE2D)


class _FrozenVAEBase:
    """The protocol over ``self.model`` (an ``nn.Module`` with ``encode`` ->
    posterior and ``decode``)."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def load_checkpoint(self, path: str):
        """Late weight load (``eval.py --ckpt``), strict=False; (missing,
        unexpected) keys."""
        return self.model.load_checkpoint(path)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def encode(self, x, return_reg_log: bool = False, unregularized: bool = False,
               eps: Optional[torch.Tensor] = None):
        posterior = self.model.encode(self._input(x))
        return posterior.sample(self.generator, eps), {}

    @torch.inference_mode()
    def decode(self, z):
        return self.model.decode(self._input(z))


class _DiffusersVAE(nn.Module):
    """The diffusers AutoencoderKL layout on the port's sd3unet backbone:
    ``encoder`` (double_z moments) and ``decoder``, float32."""

    def __init__(self, latent_channels: int, ch: int, ch_mult: Sequence[int], resolution: int):
        super().__init__()
        from vqvae_from_gaussian_vae_tpu_torch.models.unet import Decoder, Encoder

        common = dict(attn_type="vanilla", z_channels=latent_channels, resolution=resolution,
                      in_channels=3, out_ch=3, ch=ch, ch_mult=list(ch_mult), num_res_blocks=2,
                      attn_resolutions=[], dropout=0.0, double_z=True)
        self.encoder = Encoder(**common)
        self.decoder = Decoder(**common)

    def load_checkpoint(self, path: str):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        result = self.load_state_dict(sd, strict=False)
        return list(result.missing_keys), list(result.unexpected_keys)

    def encode(self, x) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution(self.encoder(x))

    def decode(self, z):
        return self.decoder(z)


class AutoencoderKLDiffusers(_FrozenVAEBase):
    """A diffusers-``AutoencoderKL``-layout VAE (the reference's FLUX, SD3 and
    EQ wrappers differ only in weights and latent width): z = (sample -
    shift) * scale, decode undoes it."""

    def __init__(self, latent_channels: int = 16, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), resolution: int = 256,
                 scaling_factor: Optional[float] = None, shift_factor: Optional[float] = None,
                 ckpt_path: Optional[str] = None, seed: int = 0, device=None):
        super().__init__(seed, device)
        self.scaling_factor = scaling_factor
        self.shift_factor = shift_factor
        self.model = _DiffusersVAE(latent_channels, ch, ch_mult, resolution)
        init_weights(self.model, seed)
        self.model.to(self.device, memory_format=torch.channels_last).eval()
        if ckpt_path:
            self.load_checkpoint(ckpt_path)
        else:
            print(f"WARNING: {type(self).__name__} running with random weights "
                  f"(pass ckpt_path with converted diffusers weights)")

    @torch.inference_mode()
    def encode(self, x, return_reg_log: bool = False, unregularized: bool = False,
               eps: Optional[torch.Tensor] = None):
        z, _ = super().encode(x, eps=eps)
        if self.shift_factor is not None:
            z = z - self.shift_factor
        if self.scaling_factor is not None:
            z = z * self.scaling_factor
        return z, {}

    @torch.inference_mode()
    def decode(self, z):
        z = self._input(z)
        if self.scaling_factor is not None:
            z = z / self.scaling_factor
        if self.shift_factor is not None:
            z = z + self.shift_factor
        return self.model.decode(z)


class AutoencoderKLFLUX(AutoencoderKLDiffusers):
    """The FLUX.1-dev VAE: 16 latent channels, f = 8, scaling 0.3611, shift 0.1159."""

    def __init__(self, ckpt_path: Optional[str] = None, seed: int = 0, device=None):
        super().__init__(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                         ckpt_path=ckpt_path, seed=seed, device=device)


class AutoencoderKLSD3(AutoencoderKLDiffusers):
    """The SD3.5-medium VAE: 16 latent channels, f = 8, scaling 1.5305, shift 0.0609."""

    def __init__(self, ckpt_path: Optional[str] = None, seed: int = 0, device=None):
        super().__init__(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                         ckpt_path=ckpt_path, seed=seed, device=device)


class AutoencoderKLEQ(AutoencoderKLDiffusers):
    """EQ-VAE: 4 SD-style latent channels, f = 8."""

    def __init__(self, ckpt_path: Optional[str] = None, seed: int = 0, device=None):
        super().__init__(latent_channels=4, ckpt_path=ckpt_path, seed=seed, device=device)


class _HunyuanWrapper(_FrozenVAEBase):
    """A HunyuanImage VAE (``HunyuanVAE2D``) at its published widths; its
    latents are the raw posterior samples, as in the reference."""

    CONFIG: dict = {}

    def __init__(self, ckpt_path: Optional[str] = None, seed: int = 0, device=None):
        super().__init__(seed, device)
        self.model = HunyuanVAE2D(in_channels=3, out_channels=3, layers_per_block=2,
                                  sample_size=384, sample_tsize=96, seed=seed,
                                  device=self.device, **self.CONFIG).eval()
        if ckpt_path:
            self.load_checkpoint(ckpt_path)
        else:
            print(f"WARNING: {type(self).__name__} running with random weights")


class AutoencoderKLHYImage2(_HunyuanWrapper):
    """The HunyuanImage-2 VAE: f = 32, 64 latent channels."""

    CONFIG = {"block_out_channels": [128, 256, 512, 512, 1024, 1024], "latent_channels": 64,
              "ffactor_spatial": 32, "scaling_factor": 0.75289}


class AutoencoderKLHYImage3(_HunyuanWrapper):
    """The HunyuanImage-3 VAE's 2-D spatial path: f = 16, 32 latent channels."""

    CONFIG = {"block_out_channels": [128, 256, 512, 1024, 1024], "latent_channels": 32,
              "ffactor_spatial": 16, "scaling_factor": 0.562679178327931}


class AutoencoderKLQwenImage(_FrozenVAEBase):
    """The Qwen-Image VAE: the causal-3D WAN autoencoder on single frames."""

    def __init__(self, ckpt_path: Optional[str] = None, seed: int = 0, device=None,
                 **wan_kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} runs on the WAN video VAE (models/wan.py), which the port "
            "does not have yet (ROADMAP.md queue A)")


class AutoencoderKLWAN(AutoencoderKLQwenImage):
    """The Wan2.2-I2V VAE: the Qwen-Image wrapper's architecture and protocol."""
