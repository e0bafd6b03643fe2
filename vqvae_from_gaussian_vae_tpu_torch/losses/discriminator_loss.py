"""LPIPS + PatchGAN adversarial loss head for the two-phase GAN step.

Port of ``vqvae_from_gaussian_vae_tpu/losses/discriminator_loss.py``
(``GeneralLPIPSWithDiscriminator``).  One module serves both phases (the
reference's ``optimizer_idx``): phase 0 is L1 + LPIPS -> the learned-logvar
NLL (summed over elements, divided by the batch) + the adaptively weighted
generator loss + the weighted regularizer terms; phase 1 is the hinge or
vanilla discriminator loss, with the real and reconstructed images
interleaved in ONE discriminator call.  The log keys are the JAX package's.

``d_weight`` is the adaptive weight or a callable ``(nll, g) -> weight``
that the train step supplies: it differentiates both losses against the
decoder's last layer on the graph this call builds
(``parallel/train_step.py``).  In eval it is 1 once the discriminator is on.

Parameters: ``perceptual_loss`` (frozen LPIPS), ``logvar`` (a scalar) and
``discriminator``.  ``dtype`` is the compute dtype of the LPIPS trunk and
the discriminator's convs; every parameter stays float32.

When the reg log holds the vf branch's ``zp`` and ``aux_feature``, phase 0
adds ``vf_weight * vf_loss`` (the distance-matrix and cosine margins
between the two, VA-VAE's).  ``vf_weight`` is the adaptive weight, a
callable ``(nll, vf) -> weight`` the train step supplies, or None: then the
configured ``vf_weight``, or 0 with ``adaptive_vf`` (the eval step).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from vqvae_from_gaussian_vae_tpu_torch.losses.discriminator import (
    ActNorm, hinge_d_loss, vanilla_d_loss)
from vqvae_from_gaussian_vae_tpu_torch.losses.lpips import LPIPS, load_lpips_weights
from vqvae_from_gaussian_vae_tpu_torch.utils.config import (
    as_torch_dtype, default, instantiate_from_config)


class GeneralLPIPSWithDiscriminator(nn.Module):
    def __init__(self, disc_start: int, logvar_init: float = 0.0, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, lpips_weights: Optional[str] = None,
                 disc_loss: str = "hinge", scale_input_to_tgt_size: bool = False, dims: int = 2,
                 learn_logvar: bool = False,
                 regularization_weights: Optional[Dict[str, float]] = None,
                 additional_log_keys: Optional[List[str]] = None,
                 discriminator_config: Optional[Dict] = None, vf_weight: float = 0.1,
                 adaptive_vf: bool = True, cos_margin: float = 0.5, distmat_margin: float = 0.25,
                 distmat_weight: float = 1.0, cos_weight: float = 1.0, dtype=torch.float32):
        super().__init__()
        del scale_input_to_tgt_size
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"unknown disc_loss {disc_loss!r}")
        if dims != 2:
            raise NotImplementedError("the video (dims > 2) loss branch is not ported")
        self.disc_start = disc_start
        self.disc_factor = disc_factor
        self.disc_weight = disc_weight
        self.perceptual_weight = perceptual_weight
        self.lpips_weights = lpips_weights
        self.learn_logvar = learn_logvar
        self.vf_weight = vf_weight
        self.adaptive_vf = adaptive_vf
        self.cos_margin = cos_margin
        self.distmat_margin = distmat_margin
        self.distmat_weight = distmat_weight
        self.cos_weight = cos_weight
        self.dtype = as_torch_dtype(dtype)
        self.perceptual_loss = LPIPS(dtype=self.dtype)
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)),
                                   requires_grad=learn_logvar)
        disc_cfg = default(discriminator_config, {
            "target": "vqvae_from_gaussian_vae_tpu.losses.discriminator.NLayerDiscriminator",
            "params": {"input_nc": disc_in_channels, "n_layers": disc_num_layers,
                       "use_actnorm": False}})
        if (disc_cfg["target"].endswith("NLayerDiscriminator")
                and "dtype" not in disc_cfg.get("params", {})):
            disc_cfg = {**disc_cfg, "params": {**disc_cfg.get("params", {}), "dtype": self.dtype}}
        self.discriminator = instantiate_from_config(disc_cfg)
        self._disc_loss_fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self._reg_weights = dict(regularization_weights or {})
        self._log_keys = set(additional_log_keys or []) | set(self._reg_weights)

    # ------------------------------------------------------------ pieces

    def rec_loss(self, inputs, reconstructions):
        """L1 + perceptual, (B, H, W, C)."""
        rec = torch.abs(inputs - reconstructions)
        if self.perceptual_weight > 0:
            rec = rec + self.perceptual_weight * self.perceptual_loss(
                inputs, reconstructions).permute(0, 2, 3, 1)
        return rec

    def nll_loss(self, rec_loss, weights=None):
        """Learned-logvar NLL: sum over elements / batch; (nll, weighted)."""
        nll = rec_loss / torch.exp(self.logvar) + self.logvar
        weighted = nll if weights is None else weights * nll
        batch = nll.shape[0]
        return torch.sum(nll) / batch, torch.sum(weighted) / batch

    def nll_from_images(self, inputs, reconstructions, weights=None):
        return self.nll_loss(self.rec_loss(inputs, reconstructions), weights)

    def g_loss(self, reconstructions, train: bool = False):
        """Generator loss -E[D(xrec)]."""
        return -torch.mean(self.discriminator(reconstructions, train=train).float())

    def d_loss(self, inputs, reconstructions, train: bool = False, init: bool = False):
        """One discriminator call over [x_0, xrec_0, x_1, xrec_1, ...]."""
        both = torch.stack([inputs.detach(), reconstructions.detach().to(inputs.dtype)], dim=1)
        both = both.reshape((-1,) + tuple(inputs.shape[1:]))
        logits = self.discriminator(both, train=train, init=init)
        pair = logits.reshape((inputs.shape[0], 2) + tuple(logits.shape[1:]))
        logits_real, logits_fake = pair[:, 0], pair[:, 1]
        return self._disc_loss_fn(logits_real, logits_fake), logits_real, logits_fake

    def vf_loss(self, regularization_log):
        """The distance-matrix and cosine margin losses between the latent
        projection ``zp`` and the foundation features ``aux_feature``."""
        zp, aux = regularization_log["zp"], regularization_log["aux_feature"]
        zf = zp.reshape(zp.shape[0], -1, zp.shape[-1])
        af = aux.reshape(aux.shape[0], -1, aux.shape[-1])
        zn = zf / torch.clamp(torch.linalg.vector_norm(zf, dim=-1, keepdim=True), min=1e-12)
        an = af / torch.clamp(torch.linalg.vector_norm(af, dim=-1, keepdim=True), min=1e-12)
        z_sim = torch.einsum("bic,bjc->bij", zn, zn)
        a_sim = torch.einsum("bic,bjc->bij", an, an)
        vf1 = torch.relu(torch.abs(z_sim - a_sim) - self.distmat_margin).mean()
        vf2 = torch.relu(1.0 - self.cos_margin - torch.sum(zn * an, dim=-1)).mean()
        return vf1 * self.distmat_weight + vf2 * self.cos_weight

    @torch.no_grad()
    def disc_logits(self, inputs, reconstructions):
        """The raw patch-logit maps of x and of xrec, each its own call."""
        return self.discriminator(inputs), self.discriminator(reconstructions)

    @torch.no_grad()
    def init_actnorm(self, inputs, reconstructions) -> None:
        """ActNorm's data-dependent init on a real batch, through the same
        interleaved call the discriminator phase makes."""
        if any(isinstance(m, ActNorm) for m in self.discriminator.modules()):
            self.d_loss(inputs, reconstructions, train=True, init=True)

    def load_pretrained(self) -> None:
        """Load the user-supplied LPIPS checkpoint, if one was named; raise
        if it leaves a VGG weight unloaded (a raw torchvision trunk without
        the heads is accepted, as the JAX package accepts it)."""
        if self.lpips_weights:
            missing, _ = load_lpips_weights(self.perceptual_loss, self.lpips_weights)
            trunk = [k for k in missing if k.startswith("net.")]
            if trunk:
                raise ValueError(f"{self.lpips_weights} lacks LPIPS trunk weights {trunk}")

    # ------------------------------------------------------------ forward

    def forward(self, inputs, reconstructions, *, regularization_log: Dict[str, torch.Tensor],
                optimizer_idx: int, global_step: int, split: str = "train", weights=None,
                d_weight=None, vf_weight=None, train: bool = False):
        disc_on = int(global_step) >= self.disc_start or not train
        if optimizer_idx == 0:
            rec = self.rec_loss(inputs, reconstructions)
            nll, weighted_nll = self.nll_loss(rec, weights)
            g = self.g_loss(reconstructions, train=train) if disc_on else nll.new_zeros(())
            if not disc_on:
                d_weight = 0.0
            elif d_weight is None:
                d_weight = 0.0 if train else 1.0
            elif callable(d_weight):
                d_weight = d_weight(nll, g)
            d_weight = torch.as_tensor(d_weight, dtype=torch.float32, device=nll.device)
            loss = weighted_nll + d_weight * self.disc_factor * g
            log = {}
            if "zp" in regularization_log and "aux_feature" in regularization_log:
                vf = self.vf_loss(regularization_log)
                if vf_weight is None:
                    vf_weight = 0.0 if self.adaptive_vf else self.vf_weight
                elif callable(vf_weight):
                    vf_weight = vf_weight(nll, vf)
                loss = loss + vf_weight * vf
                log[f"{split}/loss/vf"] = vf.detach()
            for k, v in regularization_log.items():
                if k in self._reg_weights:
                    loss = loss + self._reg_weights[k] * v
                if k in self._log_keys and torch.is_tensor(v) and v.dim() == 0:
                    log[f"{split}/{k}"] = v.detach()
            log.update({
                f"{split}/loss/total": loss.detach(),
                f"{split}/loss/nll": nll.detach(),
                f"{split}/loss/rec": rec.detach().mean(),
                f"{split}/loss/g": g.detach(),
                # a copy: the optimizer step updates logvar in place
                f"{split}/scalars/logvar": self.logvar.detach().clone(),
                f"{split}/scalars/d_weight": d_weight.detach(),
            })
            return loss, log
        if optimizer_idx == 1:
            d, logits_real, logits_fake = self.d_loss(inputs, reconstructions, train=train)
            d = self.disc_factor * d if disc_on else 0.0 * d
            log = {f"{split}/loss/disc": d.detach(),
                   f"{split}/logits/real": logits_real.detach().float().mean(),
                   f"{split}/logits/fake": logits_fake.detach().float().mean()}
            return d, log
        raise NotImplementedError(f"Unknown optimizer_idx {optimizer_idx}")


# matplotlib's "PiYG" colormap (ColorBrewer's 11 points, as r, g, b / 255),
# interpolated into its 256-entry table the way matplotlib builds it
_PIYG = np.array([(142, 1, 82), (197, 27, 125), (222, 119, 174), (241, 182, 218),
                  (253, 224, 239), (247, 247, 247), (230, 245, 208), (184, 225, 134),
                  (127, 188, 65), (77, 146, 33), (39, 100, 25)]) / 255.0
_LUT_SIZE = 256


def piyg(x: np.ndarray) -> np.ndarray:
    """matplotlib's ``colormaps["PiYG"](x)[..., :3]`` for x in [0, 1]."""
    grid = np.linspace(0.0, 1.0, len(_PIYG))
    lut = np.stack([np.interp(np.linspace(0.0, 1.0, _LUT_SIZE), grid, _PIYG[:, c])
                    for c in range(3)], axis=-1)
    idx = np.clip((np.asarray(x, np.float64) * _LUT_SIZE).astype(int), 0, _LUT_SIZE - 1)
    return lut[idx]


def visualize_disc_logits(loss_module, inputs, reconstructions) -> Dict[str, np.ndarray]:
    """Colormapped real / fake patch-logit grids, blended over the images:
    ``{"vis_logits", "vis_logits_blended"}``, NHWC numpy in [-1, 1] with
    the real half above the fake one; {} when the logit map has no pixel."""
    lr, lf = loss_module.disc_logits(inputs, reconstructions)
    lr, lf = lr.float().cpu().numpy(), lf.float().cpu().numpy()
    if lr.ndim < 4 or lr.size == 0 or lf.size == 0:
        return {}
    high = max(np.abs(lr).max(), np.abs(lf).max(), 1e-6)

    def upsample(logits, target_hw):
        reps_h = -(-target_hw[0] // logits.shape[1])
        reps_w = -(-target_hw[1] // logits.shape[2])
        up = np.repeat(np.repeat(logits, reps_h, 1), reps_w, 2)
        return up[:, :target_hw[0], :target_hw[1]]

    hw = inputs.shape[1:3]
    lr_up = upsample(lr, hw)[..., 0]
    lf_up = upsample(lf, hw)[..., 0]
    vis = np.concatenate([piyg((lr_up + high) / (2 * high)),
                          piyg((lf_up + high) / (2 * high))], axis=1)
    imgs = np.concatenate([inputs.float().cpu().numpy(),
                           reconstructions.float().cpu().numpy()], axis=1)
    imgs01 = np.clip((imgs + 1) / 2, 0, 1)
    alpha = np.concatenate([np.abs(lr_up), np.abs(lf_up)], axis=1)[..., None] / high * 0.8
    blended = alpha * vis + (1 - alpha) * imgs01
    return {"vis_logits": 2.0 * vis - 1.0, "vis_logits_blended": 2.0 * blended - 1.0}
