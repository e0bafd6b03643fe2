"""Evaluation LPIPS on the AlexNet or the VGG16 trunk.

Port of ``vqvae_from_gaussian_vae_tpu/evaluations/lpips_metric.py`` (the
reference's metric, the ``lpips`` package with ``net="alex"``): five taps
after the ReLUs of torchvision's ``AlexNet.features`` (64, 192, 384, 256,
256 channels), each unit-normalised over channels, squared difference, a
1x1 reweighting head, spatial mean, summed.  NHWC images in [-1, 1] in,
(B, 1, 1, 1) out, float32.  ``network_type="vgg"`` is the VGG16 distance
of the training loss (``losses/lpips.py:LPIPS``), as in the JAX package.

Parameter names are torchvision's and the ``lpips`` package's: the trunk's
``net.features.{0,3,6,8,10}`` and the heads' ``lin{k}.model.1.weight``, so
the JAX package's ``LPIPSMetric.load_weights`` reads a ``state_dict`` of
``LPIPSAlex`` (and of ``LPIPS``).  ``LPIPSMetric`` builds the net once on
its device (the CUDA device unless the caller passes ``device="cpu"``),
seeded unless it is given a weights file, which it loads with
``strict=True``: the ``lpips`` package's heads and torchvision's
``alexnet`` or ``vgg16`` trunk in one file, under these names
(``features.N`` and the ``lpips`` package's ``net.slice{s}.N`` are read as
``net.features.N``; ``classifier.*`` and the scaling layer are dropped).
``get_lpips`` is the reference's call signature over one cached metric per
network type and device.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.losses.lpips import (
    LPIPS, SCALE, SHIFT, NetLinLayer, _normalize_tensor)
from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import resolve_device

# (torchvision index, out channels, kernel, stride, padding); a 3x3 stride-2
# max pool follows features 0 and 3
ALEX_CFG = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1), (8, 256, 3, 1, 1),
            (10, 256, 3, 1, 1))
CHNS = tuple(c for _, c, _, _, _ in ALEX_CFG)


class AlexNetFeatures(nn.Module):
    """torchvision ``AlexNet.features`` with a tap after each ReLU (NCHW)."""

    def __init__(self):
        super().__init__()
        cin, features = 3, {}
        for idx, cout, k, stride, pad in ALEX_CFG:
            features[str(idx)] = nn.Conv2d(cin, cout, k, stride=stride, padding=pad)
            cin = cout
        self.features = nn.ModuleDict(features)

    def forward(self, x):
        taps = []
        for idx, *_ in ALEX_CFG:
            x = F.relu(self.features[str(idx)](x))
            taps.append(x)
            if idx in (0, 3):
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPSAlex(nn.Module):
    """The ``lpips`` package's distance on the AlexNet trunk."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
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
            diff = (_normalize_tensor(t0) - _normalize_tensor(t1)) ** 2
            val = val + getattr(self, f"lin{k}")(diff).mean(dim=(2, 3), keepdim=True)
        return val  # (B, 1, 1, 1)

    def _scaled(self, x):
        return (x.float().permute(0, 3, 1, 2) - self.shift) / self.scale


def seed_weights(module: nn.Module, seed: int) -> None:
    """Conv weights N(0, 1/fan_in), biases 0 (the heads have none)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, p in sorted(module.named_parameters()):
            if p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
            else:
                p.zero_()


def lpips_state_dict(state_dict) -> dict:
    """A weights file's keys in ``LPIPSAlex``'s (or ``LPIPS``'s) names."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith(("scaling_layer.", "classifier.")):
            continue
        k = re.sub(r"^net\.slice\d+\.(\d+)\.", r"net.features.\1.", k)
        k = re.sub(r"^features\.(\d+)\.", r"net.features.\1.", k)
        sd[k] = v
    return sd


class LPIPSMetric:
    """The AlexNet ("alex") or VGG16 ("vgg") LPIPS net, built once on
    ``device`` (None: the CUDA device)."""

    def __init__(self, network_type: str = "alex", weights_path: Optional[str] = None,
                 seed: int = 0, device=None):
        if network_type not in ("alex", "vgg"):
            raise ValueError(f"LPIPS network_type {network_type!r}: 'alex' or 'vgg'")
        device = resolve_device(device)
        self.module = LPIPSAlex() if network_type == "alex" else LPIPS()
        seed_weights(self.module, seed)
        if weights_path:
            self.load_weights(weights_path)
        self.module.to(device).eval()

    def load_weights(self, path: str) -> None:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        self.module.load_state_dict(lpips_state_dict(sd), strict=True)

    @torch.no_grad()
    def __call__(self, x, y, zero_mean: bool = True) -> torch.Tensor:
        """Per-sample distance; ``zero_mean``: the inputs are in [-1, 1]."""
        if not zero_mean:
            x = x * 2.0 - 1.0
            y = y * 2.0 - 1.0
        return self.module(x, y)[:, 0, 0, 0]


_METRICS: Dict[Tuple[str, torch.device], LPIPSMetric] = {}


def get_lpips(x_input, x_recon, zero_mean: bool = False, network_type: str = "alex",
              is_video: bool = False) -> torch.Tensor:
    """The reference's signature: the per-sample distance of one metric per
    network type and device, built (seeded) at its first call on
    ``x_input``'s device.  ``is_video`` is accepted and, as in the JAX
    package, changes nothing."""
    del is_video
    key = (network_type, x_input.device)
    if key not in _METRICS:
        _METRICS[key] = LPIPSMetric(network_type, device=x_input.device)
    return _METRICS[key](x_input, x_recon, zero_mean=zero_mean)
