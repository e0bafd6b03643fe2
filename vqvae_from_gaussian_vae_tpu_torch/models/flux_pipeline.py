"""The FLUX refinement pipeline and the token-decoder engines.

Port of ``vqvae_from_gaussian_vae_tpu/models/flux_pipeline.py``.
``FluxPipeline`` holds flux-dev (optionally with LoRA deltas or IP-adapter
projections), a latent-conditioned ControlNet and the FLUX VAE
(``AutoencoderKLFLUX``); a call runs the CFG + ControlNet Euler loop from
latent noise and decodes the result.  Text conditioning comes as
embeddings (zeros by default), or from the T5 / CLIP ``HFEmbedder``s when
local checkpoints (``t5_path``, ``clip_path``) are given.

``AutoencodingFluxEngine.dequant`` re-generates an image from tokens:
dequantize and decode (for the image's size), repeat the latent up to the
FLUX latent grid (``(w // zhat_w) // 8`` a side), 25 guided steps of the
pipeline with that latent as the ControlNet's condition, then the engine's
clamp.  ``AutoencodingFluxLoraEngine`` is the LoRA (rank 128) variant.

The modules are built on the pipeline's device, the CUDA card unless the
caller passes ``device="cpu"``: ``FluxPipeline(...)`` allocates them there
(flux-dev in bf16 is 23.8 GB) and ``init_params()`` seeds them from a
generator on that device, then loads any weight files (torch state_dicts
in the reference's names, strict=False).  The latent noise comes from a
generator seeded with ``seed`` (the JAX package draws ``jax.random``), or
is passed as ``noise=`` (NHWC, ``flux.get_noise``'s shape).  Calls run
under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from vqvae_from_gaussian_vae_tpu_torch.models import flux as F
from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import (
    AutoencodingEngine, resolve_device)
from vqvae_from_gaussian_vae_tpu_torch.models.third_party import AutoencoderKLFLUX


def _load_weights(module: torch.nn.Module, path: str, prefix: str = "") -> list:
    """A torch state_dict file into ``module`` (strict=False), read with
    ``weights_only=True``; keys under ``prefix`` lose it where any has it.
    Returns the missing keys."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)} or sd
    return list(module.load_state_dict(sd, strict=False).missing_keys)


class FluxPipeline:
    def __init__(self, model_type: str = "flux-dev", control_channels: int = 16,
                 lora_rank: int = 0, controlnet_depth: int = 2, ip_context_dim: int = 0,
                 ip_weights: Optional[str] = None, clip_embeddings_dim: int = 768,
                 clip_extra_context_tokens: int = 4, flux_params: Optional[F.FluxParams] = None,
                 flux_weights: Optional[str] = None, controlnet_weights: Optional[str] = None,
                 ae_weights: Optional[str] = None, t5_path: Optional[str] = None,
                 clip_path: Optional[str] = None, seed: int = 0, device=None):
        del model_type  # flux-dev is the one configuration (``flux_params`` overrides it)
        self.device = resolve_device(device)
        self.params_cfg = flux_params or F.flux_dev_params()
        self.model = F.build(F.Flux, self.params_cfg, lora_rank=lora_rank,
                             ip_context_dim=ip_context_dim, device=self.device)
        # the IP-adapter's projection: a CLIP image embedding -> context tokens
        self.image_proj_model = (
            F.build(F.ImageProjModel, cross_attention_dim=ip_context_dim,
                    clip_embeddings_dim=clip_embeddings_dim,
                    clip_extra_context_tokens=clip_extra_context_tokens, device=self.device)
            if ip_context_dim else None)
        self.controlnet = F.build(F.ControlNetFlux, self.params_cfg, control_channels,
                                  controlnet_depth, device=self.device)
        self.ae = AutoencoderKLFLUX(ckpt_path=ae_weights, seed=seed, device=self.device)
        self._weights = (flux_weights, controlnet_weights, ip_weights)
        self.seed = seed
        self.initialized = False
        from vqvae_from_gaussian_vae_tpu_torch.models.conditioner import HFEmbedder

        self.t5 = HFEmbedder(t5_path, max_length=512, device=self.device) if t5_path else None
        self.clip = HFEmbedder(clip_path, max_length=77, device=self.device) if clip_path else None

    def init_params(self, seed: Optional[int] = None) -> None:
        """Seeded weights (``flux.init_flux_weights``: flux, ControlNet and IP
        projection from seed, seed + 1, seed + 2), then the weight files."""
        seed = self.seed if seed is None else seed
        modules = (self.model, self.controlnet, self.image_proj_model)
        for i, module in enumerate(modules):
            if module is not None:
                gen = torch.Generator(device=self.device).manual_seed(seed + i)
                F.init_flux_weights(module, gen)
        fw, cw, iw = self._weights
        for path, module, name in ((fw, self.model, "flux"), (cw, self.controlnet, "controlnet")):
            if path:
                missing = _load_weights(module, path)
                if missing:
                    print(f"{name}: missing {len(missing)} keys")
        if iw and self.image_proj_model is not None:
            _load_weights(self.image_proj_model, iw, prefix="image_proj.")
        if not fw:
            print("WARNING: FluxPipeline running with random flux-dev weights")
        self.initialized = True

    @torch.inference_mode()
    def __call__(self, controlnet_image, width: int, height: int, prompt: Optional[str] = None,
                 neg_prompt: str = "", inp_txt=None, inp_vec=None, neg_inp_txt=None,
                 neg_inp_vec=None, guidance: float = 4.0, num_steps: int = 25, seed: int = 42,
                 true_gs: float = 1.0, control_weight: float = 1.0,
                 timestep_to_start_cfg: int = 5, txt_len: int = 512, image_prompt_embeds=None,
                 neg_image_prompt_embeds=None, ip_scale: float = 1.0,
                 neg_ip_scale: float = 1.0, noise: Optional[torch.Tensor] = None):
        """controlnet_image (B, h_lat, w_lat, C): the control latent -> the
        generated image (B, height, width, 3), NHWC float32."""
        if not self.initialized:
            raise RuntimeError("call init_params() first")
        dev = self.device
        controlnet_image = torch.as_tensor(controlnet_image, device=dev)
        b = controlnet_image.shape[0]
        p = self.params_cfg
        if prompt is not None and (self.t5 is None or self.clip is None):
            raise ValueError("prompt= needs both t5_path and clip_path conditioners "
                             "configured; pass embeddings via inp_txt/inp_vec instead")
        if prompt is not None:
            if inp_txt is None:
                inp_txt = self.t5([prompt]).repeat(b, 1, 1)
            if inp_vec is None:
                inp_vec = self.clip([prompt]).repeat(b, 1)
            if neg_inp_txt is None:
                neg_inp_txt = self.t5([neg_prompt]).repeat(b, 1, 1)
            if neg_inp_vec is None:
                neg_inp_vec = self.clip([neg_prompt]).repeat(b, 1)
        bf16 = torch.bfloat16

        def given(t, shape):
            return (torch.zeros(shape, device=dev) if t is None
                    else torch.as_tensor(t, device=dev)).to(bf16)

        txt = given(inp_txt, (b, txt_len, p.context_in_dim))
        vec = given(inp_vec, (b, p.vec_in_dim))
        neg_txt = given(neg_inp_txt, txt.shape)
        neg_vec = given(neg_inp_vec, vec.shape)
        txt_ids = torch.zeros((b, txt.shape[1], 3), device=dev)

        if noise is None:
            noise = F.get_noise(torch.Generator(device=dev).manual_seed(seed), b, height, width,
                                device=dev)
        noise = torch.as_tensor(noise, device=dev)
        hl, wl = noise.shape[1], noise.shape[2]
        img = F.pack_latents(noise).to(bf16)
        img_ids = F.make_img_ids(hl, wl, b, device=dev)
        timesteps = F.get_schedule(num_steps, img.shape[1])

        image_proj = neg_image_proj = None
        if image_prompt_embeds is not None:
            if self.image_proj_model is None:
                raise ValueError("image prompts need ip_context_dim > 0 at pipeline construction")
            embeds = torch.as_tensor(image_prompt_embeds, device=dev)
            image_proj = self.image_proj_model(embeds.to(bf16))
            neg = (torch.zeros_like(embeds) if neg_image_prompt_embeds is None
                   else torch.as_tensor(neg_image_prompt_embeds, device=dev))
            neg_image_proj = self.image_proj_model(neg.to(bf16))
        x = F.denoise_controlnet(
            self.model, self.controlnet, img, img_ids, txt, txt_ids, vec, neg_txt, txt_ids,
            neg_vec, controlnet_cond=controlnet_image.to(bf16), timesteps=timesteps,
            guidance=guidance, true_gs=true_gs, controlnet_gs=control_weight,
            timestep_to_start_cfg=timestep_to_start_cfg, image_proj=image_proj,
            neg_image_proj=neg_image_proj, ip_scale=ip_scale, neg_ip_scale=neg_ip_scale)
        return self.ae.decode(F.unpack_latents(x.float(), height, width))


class AutoencodingFluxEngine(AutoencodingEngine):
    """The tokenizer whose ``dequant`` re-generates the image through FLUX +
    ControlNet conditioned on the dequantized latents.  The pipeline is
    built at the first ``dequant`` (``load_flux_pipeline``), or assigned to
    ``xflux_pipeline`` beforehand."""

    def __init__(self, *, controlnet_path: Optional[str] = None,
                 lora_path: Optional[str] = None, flux_path: Optional[str] = None,
                 num_steps: int = 25, guidance: float = 4.0, **kwargs):
        super().__init__(**kwargs)
        self.controlnet_path = controlnet_path
        self.lora_path = lora_path
        self.flux_path = flux_path
        self.num_steps = num_steps
        self.guidance = guidance
        self.control_channels = kwargs["encoder_config"]["params"]["z_channels"]
        self.xflux_pipeline: Optional[FluxPipeline] = None

    def load_flux_pipeline(self) -> None:
        self.xflux_pipeline = FluxPipeline(
            control_channels=self.control_channels, lora_rank=128 if self.lora_path else 0,
            flux_weights=self.flux_path or self.lora_path,
            controlnet_weights=self.controlnet_path, device=self.device)
        self.xflux_pipeline.init_params()

    @torch.inference_mode()
    def dequant(self, indices, noise: Optional[torch.Tensor] = None):
        """indices -> the generated image, clamped; ``noise`` replaces the
        pipeline's draw from seed 42."""
        if self.xflux_pipeline is None:
            self.load_flux_pipeline()
        zhat = self.module.regularization.dequant(self._input(indices))
        rec = self.decode(zhat)
        _, h, w, _ = rec.shape
        # the control latent repeated up to the FLUX latent grid (image / 8)
        scale = (w // zhat.shape[2]) // 8
        control = zhat
        if scale > 1:
            control = zhat.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
        result = self.xflux_pipeline(controlnet_image=control, width=w, height=h,
                                     guidance=self.guidance, num_steps=self.num_steps, seed=42,
                                     true_gs=1.0, control_weight=1.0, timestep_to_start_cfg=5,
                                     noise=noise)
        return self.module._clamp(result)


class AutoencodingFluxLoraEngine(AutoencodingFluxEngine):
    """The LoRA-only variant: the rank-128 deltas live inside flux's weights."""

    def __init__(self, *, lora_path: Optional[str] = None, **kwargs):
        super().__init__(lora_path=lora_path, **kwargs)
