"""Rectified-flow reconstruction enhancer: the post engine.

Port of ``vqvae_from_gaussian_vae_tpu/models/postprocessor.py``
(``AutoencodingPostEngine``).  A frozen autoencoder (the port's
``AutoencodingEngine``) gives xhat = decode(encode(x)); a trainable velocity
net, the "poster" (``models/hdit.py:create_hdit_model`` in the shipped
setup), learns the flow from the noised reconstruction
xhat_0 = xhat + mmse_noise_std * n towards the original x:

    train: t ~ U(0, 1); x_t = t x + (1 - t) xhat_0;  min |v(x_t, t) - (x - xhat_0)|^2
    post:  Euler steps of v from xhat_0 over num_flow_steps

``post`` is a Python loop over the steps (the JAX package's is one jitted
``lax.scan``); its noise comes from an explicit ``torch.Generator``, or is
injected (``noise=``), since torch cannot replay ``jax.random``.  The train
step takes ``t`` and ``noise`` injected the same way.  The engine runs on the
CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import (
    AutoencodingEngine, resolve_device)
from vqvae_from_gaussian_vae_tpu_torch.models.hdit import init_hdit_weights
from vqvae_from_gaussian_vae_tpu_torch.utils.config import default, instantiate_from_config


class AutoencodingPostEngine:
    def __init__(self, *, input_key: str = "img", eval_only: bool = False,
                 encoder_config: Dict, decoder_config: Dict, post_config: Dict,
                 regularizer_config: Dict, optimizer_config: Optional[Dict] = None,
                 ckpt_path: Optional[str] = None, ckpt_engine: Optional[str] = None,
                 additional_decode_keys: Optional[List[str]] = None,
                 clamp_range: Optional[Sequence[float]] = None, num_flow_steps: int = 50,
                 mmse_noise_std: float = 0.1, seed: int = 0, device=None, **kwargs):
        if additional_decode_keys:
            raise NotImplementedError(
                "additional_decode_keys is not supported: decode(z) takes no extra batch "
                f"keys (got {sorted(additional_decode_keys)})")
        if kwargs:
            raise TypeError(f"AutoencodingPostEngine got unsupported kwargs: {sorted(kwargs)}")
        self.input_key = input_key
        self.eval_only = eval_only
        self.num_flow_steps = num_flow_steps
        self.mmse_noise_std = mmse_noise_std
        self.eps = 0.0
        self.clamp_range = tuple(clamp_range) if clamp_range is not None else None
        del optimizer_config  # accepted as the JAX engine's: the train step is Adam
        self.device = resolve_device(device)
        # the frozen autoencoder (the shared encode / decode / quant API)
        self.ae = AutoencodingEngine(input_key=input_key, encoder_config=encoder_config,
                                     decoder_config=decoder_config,
                                     regularizer_config=regularizer_config, loss_config=None,
                                     clamp_range=clamp_range, seed=seed, device=self.device)
        self.poster = instantiate_from_config(post_config)
        self.init_params(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        ckpt = default(ckpt_path, ckpt_engine)
        if ckpt:
            self.load_checkpoint(ckpt)

    # ------------------------------------------------------------- params

    def init_params(self, seed: int = 0) -> None:
        """Seeded poster weights (``models/hdit.py:init_hdit_weights``), on
        the engine's device; the autoencoder keeps its own."""
        self.poster.to("cpu")
        init_hdit_weights(self.poster, seed + 1)
        self.poster.to(self.device)

    def load_checkpoint(self, path: str, ignore_keys: Sequence[str] = ()):
        """Loads the autoencoder's weights only, as the JAX engine does
        (a checkpoint's ``poster.`` keys are not read); (missing, unexpected)."""
        return self.ae.load_checkpoint(path, ignore_keys=ignore_keys)

    # ------------------------------------------------------------- API

    def get_input(self, batch):
        return batch[self.input_key]

    def encode(self, x, return_reg_log: bool = False, unregularized: bool = False):
        return self.ae.encode(x, return_reg_log=return_reg_log, unregularized=unregularized)

    def decode(self, z):
        return self.ae.decode(z)

    def quant(self, x):
        return self.ae.quant(x)

    def dequant(self, indices):
        return self.ae.dequant(indices)

    def __call__(self, x_t, t):
        return self.poster(x_t, t)

    def _noise(self, shape, generator: Optional[torch.Generator]):
        return torch.randn(shape, generator=default(generator, self.generator),
                           device=self.device)

    @torch.inference_mode()
    def post(self, xhat, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None):
        """Euler integration of the poster's flow from xhat_0 = xhat +
        mmse_noise_std * noise (``noise`` standard normal, drawn from the
        generator unless given)."""
        xhat = torch.as_tensor(xhat, device=self.device).float()
        if noise is None:
            noise = self._noise(xhat.shape, generator)
        x_t = xhat + torch.as_tensor(noise, device=self.device).float() * self.mmse_noise_std
        n = self.num_flow_steps
        dt = (1.0 / n) * (1.0 - self.eps)
        for i in range(n):
            t = torch.full((x_t.shape[0],), (i / n) * (1.0 - self.eps) + self.eps,
                           dtype=torch.float32, device=self.device)
            x_t = x_t + self.poster(x_t, t) * dt
        if self.clamp_range is not None:
            x_t = torch.clamp(x_t, self.clamp_range[0], self.clamp_range[1])
        return x_t

    # ------------------------------------------------------------- training

    def flow_loss(self, x, generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """The rectified-flow loss of a batch, with a graph to the poster's
        parameters.  The autoencoder runs its eval branch (the GQ search)
        with no graph; ``t`` (B,) and ``noise`` (standard normal, x's shape)
        are drawn from the generator unless given."""
        gen = default(generator, self.generator)
        x = torch.as_tensor(x, device=self.device).float()
        with torch.no_grad():
            z = self.ae.module.encode(x, generator=self.ae.generator)
            xhat = self.ae.module.decode(z).float()
        b = x.shape[0]
        if t is None:
            t = torch.rand((b,), generator=gen, device=self.device)
        t = (torch.as_tensor(t, device=self.device).float() * (1.0 - self.eps)
             + self.eps).reshape(b, 1, 1, 1)
        if noise is None:
            noise = self._noise(xhat.shape, gen)
        xhat_0 = xhat + torch.as_tensor(noise, device=self.device).float() * self.mmse_noise_std
        x_t = t * x + (1.0 - t) * xhat_0
        v = self.poster(x_t, t.reshape(b))
        return torch.mean((v - (x - xhat_0)) ** 2)

    def make_train_step(self, learning_rate: float):
        """(train_step, optimizer): one Adam step on the poster's parameters
        (optax's defaults: betas 0.9, 0.999, eps 1e-8) a call; the
        autoencoder stays frozen.  ``train_step(x, generator=None, t=None,
        noise=None)`` returns the loss; the gradient stays in each
        parameter's ``.grad`` until the next call."""
        if self.eval_only:
            raise RuntimeError("AutoencodingPostEngine was built with eval_only=True; "
                               "it has no optimizer to train with")
        opt = torch.optim.Adam(self.poster.parameters(), lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)

        def train_step(x, generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
            opt.zero_grad(set_to_none=True)
            loss = self.flow_loss(x, generator, t, noise)
            loss.backward()
            opt.step()
            return loss.detach()

        return train_step, opt

    def log_images(self, batch, **kwargs):
        x = torch.as_tensor(self.get_input(batch), device=self.device)
        xhat = self.decode(self.encode(x))
        return {"inputs": x, "xhat": xhat, "xhat_post": self.post(xhat)}
