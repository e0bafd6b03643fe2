"""LPIPS perceptual loss on a VGG16 trunk.

Port of ``vqvae_from_gaussian_vae_tpu/losses/lpips.py``: five feature taps
(relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), each unit-normalised over
channels, squared difference, a learned 1x1 reweighting (``NetLinLayer``),
spatial mean, summed over taps.  NHWC images in [-1, 1] in, (B, 1, 1, 1)
out.  The convolutions run in ``dtype`` on float32 weights cast at use; the
normalisation and the heads run in float32.

Parameter names follow torchvision and the reference: the trunk's
``net.features.N`` and the heads' ``lin{k}.model.1``.  The parameters are
frozen (``requires_grad`` False).  Pretrained weights come only from a
user-supplied ``.pth`` (``load_lpips_weights``); without one they are
seeded.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.utils.config import as_torch_dtype

# torchvision vgg16.features conv indices and channel widths
VGG_CFG = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
           (17, 512), (19, 512), (21, 512), (24, 512), (26, 512), (28, 512))
_POOL_BEFORE = {5, 10, 17, 24}  # a 2x2 max pool sits before these convs
_TAPS = (2, 7, 14, 21, 28)      # the relu outputs of these convs are the taps
CHNS = (64, 128, 256, 512, 512)
# the reference's fixed input scaling layer
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """torchvision-layout VGG16 trunk emitting the five LPIPS taps (NCHW)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        features = {}
        cin = 3
        for idx, width in VGG_CFG:
            features[str(idx)] = nn.Conv2d(cin, width, 3, padding=1)
            cin = width
        self.features = nn.ModuleDict(features)

    def forward(self, x):
        taps = []
        x = x.to(self.dtype)
        for idx, _ in VGG_CFG:
            if idx in _POOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            conv = self.features[str(idx)]
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), padding=1))
            if idx in _TAPS:
                taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """The 1x1 reweighting head; ``model.0`` is the reference's dropout,
    an identity in the frozen loss."""

    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(chn_in, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def _normalize_tensor(x, eps: float = 1e-10):
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """NHWC images in [-1, 1] -> (B, 1, 1, 1) perceptual distance."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.net = VGG16Features(dtype)
        for k, ch in enumerate(CHNS):
            self.add_module(f"lin{k}", NetLinLayer(ch))
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def forward(self, input, target):
        taps0 = self.net(self._scaled(input))
        taps1 = self.net(self._scaled(target))
        val = 0.0
        for k, (t0, t1) in enumerate(zip(taps0, taps1)):
            diff = (_normalize_tensor(t0.float()) - _normalize_tensor(t1.float())) ** 2
            val = val + getattr(self, f"lin{k}")(diff).mean(dim=(2, 3), keepdim=True)
        return val  # (B, 1, 1, 1)

    def _scaled(self, x):
        """NHWC [-1, 1] -> the trunk's NCHW input (a channels-last view)."""
        return (x.float().permute(0, 3, 1, 2) - self.shift) / self.scale


def load_lpips_weights(module: LPIPS, path: str):
    """Load a torch LPIPS checkpoint (the reference's combined ``vgg.pth``:
    ``net.slice{s}.{n}.*`` trunk keys and ``lin{k}.model.1.weight`` heads),
    or raw torchvision ``features.N.*`` keys, into ``module``.  Returns
    (missing, unexpected) keys."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("scaling_layer."):
            continue  # the fixed SHIFT / SCALE constants
        k = re.sub(r"^net\.slice\d+\.(\d+)\.", r"net.features.\1.", k)
        k = re.sub(r"^features\.(\d+)\.", r"net.features.\1.", k)
        sd[k] = v
    result = module.load_state_dict(sd, strict=False)
    return list(result.missing_keys), list(result.unexpected_keys)
