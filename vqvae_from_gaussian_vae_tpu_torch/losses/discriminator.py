"""PatchGAN discriminator with ActNorm, and the discriminator losses.

Port of ``vqvae_from_gaussian_vae_tpu/losses/discriminator.py``: the
pix2pix ``NLayerDiscriminator`` (4x4 convs, a stride-2 pyramid, LeakyReLU
0.2, ActNorm or BatchNorm, a one-channel logit map), ``ActNorm`` with its
data-dependent initialisation, ``hinge_d_loss`` and ``vanilla_d_loss``.

NHWC images in, NHWC logits out; inside, the convs run on NCHW views of
channels-last tensors.  The convolutions compute in ``dtype`` on float32
weights cast at use; ActNorm's affine is float32 and its output takes the
activation dtype.  Module names ``main.{i}`` are the reference's Sequential
indices.

ActNorm initialises from the first batch it is given in init mode
(``forward(x, init=True)``): loc = -mean and scale = 1 / (std + 1e-6), the
unbiased std over N*H*W per channel, as the reference's lazy first
training forward and the JAX package's init on a real batch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.utils.config import as_torch_dtype


class ActNorm(nn.Module):
    """Per-channel float32 affine with batch-statistics init; (1, C, 1, 1)
    ``loc`` and ``scale``, as the reference's."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1))

    @torch.no_grad()
    def initialize(self, x):
        xf = x.float()
        self.loc.copy_(-xf.mean(dim=(0, 2, 3)).reshape(self.loc.shape))
        std = xf.transpose(0, 1).reshape(xf.shape[1], -1).std(dim=1)  # unbiased
        self.scale.copy_((1.0 / (std + 1e-6)).reshape(self.scale.shape))

    def forward(self, x, init: bool = False):
        if init:
            self.initialize(x)
        return (self.scale * (x.float() + self.loc)).to(x.dtype)


class _Conv(nn.Conv2d):
    """4x4 conv, padding 1, computed in ``dtype`` on float32 weights."""

    def __init__(self, cin: int, cout: int, stride: int, bias: bool, dtype):
        super().__init__(cin, cout, 4, stride=stride, padding=1, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class NLayerDiscriminator(nn.Module):
    """NHWC (B, H, W, input_nc) -> NHWC (B, h, w, 1) patch logits."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.use_actnorm = use_actnorm
        dt = self.dtype
        norm = ActNorm if use_actnorm else nn.BatchNorm2d
        use_bias = use_actnorm  # BatchNorm's affine takes the bias's place
        layers = [_Conv(input_nc, ndf, 2, True, dt), nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers):
            nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
            layers += [_Conv(ndf * nf_prev, ndf * nf_mult, 2, use_bias, dt),
                       norm(ndf * nf_mult), nn.LeakyReLU(0.2)]
        nf_prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        layers += [_Conv(ndf * nf_prev, ndf * nf_mult, 1, use_bias, dt),
                   norm(ndf * nf_mult), nn.LeakyReLU(0.2)]
        layers.append(_Conv(ndf * nf_mult, 1, 1, True, dt))
        self.main = nn.Sequential(*layers)

    def forward(self, x, train: bool = False, init: bool = False):
        if train and not self.use_actnorm:
            # as the JAX package: the two-phase step threads no running
            # statistics; every shipped config trains with ActNorm
            raise NotImplementedError(
                "training the BatchNorm discriminator variant is not wired; "
                "set discriminator_config.params.use_actnorm: true")
        h = x.permute(0, 3, 1, 2)
        for m in self.main:
            if isinstance(m, ActNorm):
                h = m(h, init=init)
            elif isinstance(m, nn.BatchNorm2d):
                h = F.batch_norm(h, m.running_mean, m.running_var, m.weight, m.bias,
                                 training=False, eps=m.eps).to(h.dtype)
            else:
                h = m(h)
        return h.permute(0, 2, 3, 1)


def hinge_d_loss(logits_real, logits_fake):
    """0.5 (mean relu(1 - real) + mean relu(1 + fake)), in float32."""
    loss_real = torch.mean(F.relu(1.0 - logits_real.float()))
    loss_fake = torch.mean(F.relu(1.0 + logits_fake.float()))
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real, logits_fake):
    """0.5 (mean softplus(-real) + mean softplus(fake)), in float32."""
    return 0.5 * (torch.mean(F.softplus(-logits_real.float()))
                  + torch.mean(F.softplus(logits_fake.float())))
