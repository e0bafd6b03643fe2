"""Gaussian-quantization regularizers: the paper's contribution.

Port of ``vqvae_from_gaussian_vae_tpu/quantization/gaussian.py``
(``GaussianQuantRegularizer``, ``init_duals``, ``update_duals``, and the
baselines ``GaussianRegularizer``, ``IdentityRegularizer`` and
``GaussianQuantRegularizer2`` at the end of this module).

Train branch: plain Gaussian-VAE sampling plus a three-band KL loss that
pushes each group's KL (in bits) toward log2(n_samples) within
``tolerance``, weighted by the multiplicative dual variables (lam, lam_min,
lam_max).  The duals are three float32 tensors in the caller's train state,
updated every training forward from the batch's KL statistics.

Eval branch: the encoder's (mu, logvar) posterior is turned into token
indices by a nearest-sample search over the fixed 2^16 Gaussian codebook
(``ops/gq_search.py``), and ``dequant`` maps indices back to latents.

Channel grouping is the reference's: c -> (group, c // group) row-major, so
each of the ng = c // group index groups gathers the strided channels
{j, ng + j, 2 ng + j, ...}.

Both branches draw eps (the train sample ``mu + eps * std``, the eval
branch's ``zhat_noquant``) from the caller's ``torch.Generator``, or take it
injected (``eps=``), since torch cannot replay ``jax.random``.  Under data
parallelism the caller passes ``noise_rows=(rank, world)``: every rank
draws eps for the joined batch of world x B rows from the same generator
state and keeps its own rows, as the JAX package's replicated key draws
the global batch's noise and shards it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.ops import codebook as codebook_ops
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import (
    KERNEL_BACKENDS, PLAIN_BACKENDS, gq_search)
from vqvae_from_gaussian_vae_tpu_torch.quantization.common import (
    ALL_FORMATS, IMAGE_FORMATS, from_tokens, to_tokens)


LOG2E = 1.4426  # the reference's truncated log2(e), kept as the JAX package keeps it


def init_duals(device=None) -> Dict[str, torch.Tensor]:
    """lam, lam_min, lam_max, each a float32 scalar 1."""
    return {k: torch.ones((), dtype=torch.float32, device=device)
            for k in ("lam", "lam_min", "lam_max")}


def update_duals(duals: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
                 log_n_samples: float, tolerance: float, lam_factor: float,
                 lam_range: Tuple[float, float] = (1e-3, 1e3)) -> Dict[str, torch.Tensor]:
    """Multiplicative dual update from the batch's "bits-mean", "bits-min"
    and "bits-max"; returns new tensors (no host round trip)."""
    f, inv = float(lam_factor), 1.0 / float(lam_factor)
    lam = duals["lam"] * torch.where(stats["bits-mean"] > log_n_samples, f, inv)
    lam_max = duals["lam_max"] * torch.where(stats["bits-max"] > log_n_samples + tolerance, f, inv)
    lam_max = torch.clamp(lam_max, 1.0, lam_range[1])
    lam_min = duals["lam_min"] * torch.where(stats["bits-min"] < log_n_samples - tolerance, inv, f)
    lam_min = torch.clamp(lam_min, lam_range[0], 1.0)
    return {"lam": lam, "lam_min": lam_min, "lam_max": lam_max}


def draw_eps(shape, generator: Optional[torch.Generator], device,
             noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Standard-normal float32 eps of ``shape``; with ``noise_rows`` (rank,
    world), rows [rank B, (rank + 1) B) of a draw for world x B rows."""
    if noise_rows is None or noise_rows[1] == 1:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    r, w = noise_rows
    b = shape[0]
    full = torch.randn((w * b,) + tuple(shape[1:]), generator=generator, device=device,
                       dtype=torch.float32)
    return full[r * b:(r + 1) * b]


def _split_posterior(z: torch.Tensor, logvar_range) -> Tuple[torch.Tensor, ...]:
    """z (..., 2C) -> mu, logvar (clamped), std, all float32."""
    mu, logvar = torch.chunk(z.float(), 2, dim=-1)
    logvar = torch.clamp(logvar, logvar_range[0], logvar_range[1])
    std = torch.exp(0.5 * logvar)
    return mu, logvar, std


class GaussianQuantRegularizer(nn.Module):
    """Per-group GQ regularizer; the codebook is a non-persistent buffer
    (checkpoints do not carry it)."""

    def __init__(self, format: str, n_samples: int, group: int = 1,
                 logvar_range: Tuple[float, float] = (-30.0, 20.0), tolerance: float = 0.5,
                 lam_factor: float = 1.01, seed: int = 42, beta: float = 1.0,
                 backend: str = "auto"):
        super().__init__()
        if format not in ALL_FORMATS:
            raise ValueError(f"unknown format {format!r}")
        if backend not in KERNEL_BACKENDS + PLAIN_BACKENDS:
            raise ValueError(f"unknown gq_search backend {backend!r}")
        self.format = format
        self.n_samples = n_samples
        self.group = group
        self.logvar_range = tuple(logvar_range)
        self.tolerance = tolerance
        self.lam_factor = lam_factor
        self.beta = beta
        self.backend = backend
        self.log_n_samples = int(math.log(n_samples, 2))
        table = codebook_ops.prior_samples(n_samples, group, seed)
        self.register_buffer("codebook", torch.from_numpy(table.copy()), persistent=False)

    def rows(self, mu: torch.Tensor) -> torch.Tensor:
        """(B, L, C) -> (B*L*ng, group) with the strided grouping."""
        b, l, c = mu.shape
        ng = c // self.group
        return mu.reshape(b, l, self.group, ng).transpose(2, 3).reshape(-1, self.group)

    def forward(self, z: torch.Tensor, train: bool = False,
                duals: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                noise_rows: Optional[Tuple[int, int]] = None):
        zt, hw = to_tokens(z, self.format)
        b, l, c2 = zt.shape
        c = c2 // 2
        ng = c // self.group
        mu, logvar, std = _split_posterior(zt, self.logvar_range)
        if eps is None:
            eps = draw_eps(mu.shape, generator, mu.device, noise_rows)
        eps = eps.reshape(mu.shape).to(mu)
        if train:
            return self._train(mu, logvar, std, eps, duals, hw)
        zhat_noquant = mu + eps * std
        indices = gq_search(self.rows(mu), self.rows(std), self.codebook, beta=self.beta,
                            backend=self.backend)
        zhat = self.codebook[indices.long()]
        zhat = zhat.reshape(b, l, ng, self.group).transpose(2, 3).reshape(b, l, c)
        indices = indices.reshape(b, l, ng)
        zhat = from_tokens(zhat, self.format, hw)
        zhat_noquant = from_tokens(zhat_noquant, self.format, hw)
        if hw is not None:
            indices = indices.reshape(b, hw[0], hw[1], ng)
        return zhat, {"indices": indices, "zhat_noquant": zhat_noquant}

    def _train(self, mu, logvar, std, eps, duals, hw):
        """The reparameterised sample and the three-band KL loss."""
        if duals is None:
            duals = init_duals(mu.device)
        b, l, c = mu.shape
        ng = c // self.group
        zhat = mu + eps * std
        # KL in bits per (b, l, bit-group): summed over the strided group axis
        kl2 = LOG2E * 0.5 * (mu * mu + torch.exp(logvar) - 1.0 - logvar)
        kl2 = kl2.reshape(b, l, self.group, ng).sum(dim=2)
        target = float(self.log_n_samples)
        hi, lo = target + self.tolerance, target - self.tolerance
        ge = (kl2 > hi).to(kl2.dtype) * duals["lam_max"]
        eq = (kl2 <= hi).to(kl2.dtype) * (kl2 >= lo).to(kl2.dtype)
        le = (kl2 < lo).to(kl2.dtype) * duals["lam_min"]
        kl_loss = ((ge + eq + le) * kl2).sum(dim=(1, 2)).mean() * duals["lam"]
        k = kl2.detach()
        info = {"kl_loss": kl_loss, "bits-mean": k.mean(), "bits-min": k.min(),
                "bits-max": k.max(), "lam": duals["lam"]}
        return from_tokens(zhat, self.format, hw), info

    def dequant(self, indices: torch.Tensor) -> torch.Tensor:
        """indices -> zhat via codebook lookup and group interleave."""
        if self.format in IMAGE_FORMATS:
            b, h, w, ng = indices.shape
            l, hw = h * w, (h, w)
        else:
            b, l, ng = indices.shape
            hw = None
        zhat = self.codebook[indices.reshape(-1).long()]
        zhat = zhat.reshape(b, l, ng, self.group).transpose(2, 3).reshape(b, l, ng * self.group)
        return from_tokens(zhat, self.format, hw)


class GaussianRegularizer(nn.Module):
    """The plain Gaussian-VAE KL regularizer: the reparameterised sample
    and the standard KL (summed over tokens and channels, averaged over the
    batch) under the key "kl".  No codebook: ``dequant`` raises."""

    def __init__(self, format: str, logvar_range: Tuple[float, float] = (-30.0, 20.0)):
        super().__init__()
        if format not in ALL_FORMATS:
            raise ValueError(f"unknown format {format!r}")
        self.format = format
        self.logvar_range = tuple(logvar_range)

    def forward(self, z, train: bool = False, duals=None, generator=None, eps=None,
                noise_rows=None):
        zt, hw = to_tokens(z, self.format)
        mu, logvar, std = _split_posterior(zt, self.logvar_range)
        if eps is None:
            eps = draw_eps(mu.shape, generator, mu.device, noise_rows)
        zhat = mu + eps.reshape(mu.shape).to(mu) * std
        kl = (0.5 * torch.sum(mu * mu + torch.exp(logvar) - 1.0 - logvar, dim=(1, 2))).mean()
        zhat = from_tokens(zhat, self.format, hw)
        if train:
            return zhat, {"kl": kl}
        return zhat, {"kl": kl, "zhat_noquant": zhat}

    def dequant(self, indices):
        raise NotImplementedError("pure Gaussian VAE has no codebook to dequantize from")


class IdentityRegularizer(nn.Module):
    """Pass-through."""

    def forward(self, z, train: bool = False, duals=None, generator=None, eps=None,
                noise_rows=None):
        return z, {}

    def dequant(self, indices):
        return indices


class GaussianQuantRegularizer2(nn.Module):
    """Dimension-generic GQ with a straight-through estimate.

    The channel axis ``dim_idx`` (the last, NHWC) holds (mu, logvar); each
    half splits into contiguous sub-codebooks of width ``dim``.  Every
    forward, train or eval, runs both branches: the Gaussian sample with the
    three-band KL loss (its mean over rows and sub-codebooks) and the search
    over the fixed 2^n codebook (``gq_search`` with ``beta``: the kernel on
    the card); with ``use_ste`` the output is the Gaussian sample's
    gradient on the code's value.  ``lam_range`` defaults to (1e-7, 1e7);
    ``lam_max`` decays symmetrically, as the JAX package implements it.
    """

    def __init__(self, dim: int, codebook_size: int, dim_idx: int = -1,
                 logvar_range: Tuple[float, float] = (-30.0, 20.0), tolerance: float = 0.5,
                 lam_factor: float = 1.01, seed: int = 42, beta: float = 1.0,
                 use_ste: bool = True, backend: str = "auto",
                 lam_range: Tuple[float, float] = (1e-7, 1e7)):
        super().__init__()
        if backend not in KERNEL_BACKENDS + PLAIN_BACKENDS:
            raise ValueError(f"unknown gq_search backend {backend!r}")
        self.dim = dim
        self.codebook_size = codebook_size
        self.dim_idx = dim_idx
        self.logvar_range = tuple(logvar_range)
        self.tolerance = tolerance
        self.lam_factor = lam_factor
        self.beta = beta
        self.use_ste = use_ste
        self.backend = backend
        self.lam_range = tuple(lam_range)
        self.log_n_samples = int(math.log(codebook_size, 2))
        table = codebook_ops.prior_samples(codebook_size, dim, seed)
        self.register_buffer("codebook", torch.from_numpy(table.copy()), persistent=False)

    def _to_rows(self, z):
        z = torch.movedim(z, self.dim_idx, -1)
        if z.shape[-1] % (self.dim * 2):
            raise ValueError(f"GaussianQuantRegularizer2: {z.shape[-1]} channels are not a "
                             f"multiple of 2 x dim {self.dim}")
        return z.reshape(-1, z.shape[-1]), tuple(z.shape)

    def _from_rows(self, x, shape):
        return torch.movedim(x.reshape(*shape[:-1], -1), -1, self.dim_idx)

    def quant_gaussian(self, z, duals, eps):
        rows, shape = self._to_rows(z)
        codebook_num = shape[-1] // (self.dim * 2)
        mu, logvar, std = _split_posterior(rows, self.logvar_range)
        zhat = mu + eps.reshape(mu.shape).to(mu) * std
        kl2 = LOG2E * 0.5 * (mu * mu + torch.exp(logvar) - 1.0 - logvar)
        kl2 = kl2.reshape(-1, codebook_num, self.dim).sum(dim=-1)
        target = float(self.log_n_samples)
        hi, lo = target + self.tolerance, target - self.tolerance
        ge = (kl2 > hi).to(kl2.dtype) * duals["lam_max"]
        eq = (kl2 <= hi).to(kl2.dtype) * (kl2 >= lo).to(kl2.dtype)
        le = (kl2 < lo).to(kl2.dtype) * duals["lam_min"]
        kl_loss = torch.mean((ge + eq + le) * kl2) * duals["lam"]
        k = kl2.detach()
        info = {"kl_loss": kl_loss, "bits-mean": k.mean(), "bits-min": k.min(),
                "bits-max": k.max(), "lam": duals["lam"], "lam-min": duals["lam_min"],
                "lam-max": duals["lam_max"], "mu": self._from_rows(mu, shape),
                "std": self._from_rows(std, shape),
                "zhat_noquant": self._from_rows(zhat, shape)}
        return self._from_rows(zhat, shape), info

    def quant_vq(self, z):
        rows, shape = self._to_rows(z.detach())
        codebook_num = shape[-1] // (self.dim * 2)
        mu, _, std = _split_posterior(rows, self.logvar_range)
        indices = gq_search(mu.reshape(-1, self.dim), std.reshape(-1, self.dim), self.codebook,
                            beta=self.beta, backend=self.backend)
        zhat = self.codebook[indices.long()].reshape(-1, codebook_num * self.dim)
        zhat = self._from_rows(zhat, shape)
        indices = self._from_rows(indices.reshape(-1, codebook_num), shape)
        return zhat, {"indices": indices, "zhat_quant": zhat}

    def forward(self, z, train: bool = False, duals=None, generator=None, eps=None,
                noise_rows=None):
        if duals is None:
            duals = init_duals(z.device)
        if eps is None:
            shape = torch.movedim(z, self.dim_idx, -1).shape
            eps = draw_eps(shape[:-1] + (shape[-1] // 2,), generator, z.device, noise_rows)
        zhat_g, info_g = self.quant_gaussian(z, duals, eps)
        zhat_v, info_v = self.quant_vq(z)
        if self.use_ste:
            zhat = zhat_g - zhat_g.detach() + zhat_v
        else:
            zhat = zhat_g if train else zhat_v
        return zhat, {**info_g, **info_v}

    def dequant(self, indices):
        indices = torch.movedim(indices, self.dim_idx, -1)
        i_shape = indices.shape
        zhat = self.codebook[indices.reshape(-1).long()]
        zhat = zhat.reshape(*i_shape[:-1], i_shape[-1] * self.dim)
        return torch.movedim(zhat, -1, self.dim_idx)
