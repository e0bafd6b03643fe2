"""I3D (Inflated 3D Inception), the video feature extractor of FVD.

Port of ``vqvae_from_gaussian_vae_tpu/evaluations/i3d.py``: the canonical
Kinetics-400 I3D (GoogLeNet inflated to 3-D) in the pytorch-i3d layout.
``Unit3D`` is a bias-free Conv3d, BatchNorm3d (eps 1e-3, running
statistics) and ReLU, with TensorFlow's SAME padding (asymmetric for even
sizes: an explicit ``F.pad`` before the conv, ``-inf`` before each max
pool); the Inception branches are ``b0 / b1a / b1b / b2a / b2b / b3b``, the
trunk ``Conv3d_1a_7x7 .. Mixed_5c`` (widths fixed by ``_MIXED``), then a
(2, 7, 7) VALID average pool, the 1x1x1 ``logits`` conv with a bias and a
mean over the remaining positions: 400 pre-softmax logits a clip, the FVD
feature.  It takes at least 9 frames (a temporal stride of 8, then the
window-2 pool).

Clips are channel-last, (N, T, H, W, C) in [-1, 1], as in the JAX package;
inside the net they are NCTHW.  ``resize`` resizes frames to 224 x 224
(bilinear, half-pixel centers, no antialias: ``jax.image.resize``'s
``antialias=False``); ``rescale`` maps [0, 255] to [-1, 1].  Module names
are the torch tree's, so the JAX ``load_i3d_weights`` reads this module's
``state_dict`` and ``load_i3d_weights`` here reads a pytorch-i3d one (its
``module.`` or ``i3d.`` prefix dropped).  The net is on the CUDA device
unless the caller passes ``device="cpu"``; without weights it is seeded, and
only relative comparisons mean anything.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import resolve_device


def _same_pads(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> Tuple[int, ...]:
    """TF SAME padding of an NCTHW tensor's (T, H, W), in ``F.pad`` order
    (W first), the odd pixel after."""
    pads = []
    for size, k, s in reversed(list(zip(x.shape[2:], kernel, stride))):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


def _max_pool_3d(x: torch.Tensor, window: Sequence[int], stride: Sequence[int]):
    """TF-SAME max pool over (T, H, W): the pad is -inf."""
    return F.max_pool3d(F.pad(x, _same_pads(x, window, stride), value=-math.inf),
                        tuple(window), tuple(stride))


class Unit3D(nn.Module):
    """Conv3d (no bias) + BatchNorm3d (eps 1e-3) + ReLU; the logits head has
    a bias and neither norm nor activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1), use_bn: bool = True,
                 use_relu: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.use_relu = tuple(kernel), tuple(stride), use_relu
        self.conv3d = nn.Conv3d(in_channels, out_channels, kernel, stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-3) if use_bn else None

    def forward(self, x):
        x = self.conv3d(F.pad(x, _same_pads(x, self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x


class InceptionModule(nn.Module):
    """1x1 | 1x1 -> 3x3 | 1x1 -> 3x3 | max pool -> 1x1, concatenated."""

    def __init__(self, in_channels: int, channels: Tuple[int, int, int, int, int, int]):
        super().__init__()
        c = channels
        self.b0 = Unit3D(in_channels, c[0])
        self.b1a = Unit3D(in_channels, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, c[5])
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x):
        b3 = self.b3b(_max_pool_3d(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


# (b0, b1a, b1b, b2a, b2b, b3b) of each Mixed stage: inflated GoogLeNet
_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),      # in 192  -> 256
    "Mixed_3c": (128, 128, 192, 32, 96, 64),    # in 256  -> 480
    "Mixed_4b": (192, 96, 208, 16, 48, 64),     # in 480  -> 512
    "Mixed_4c": (160, 112, 224, 24, 64, 64),    # in 512  -> 512
    "Mixed_4d": (128, 128, 256, 24, 64, 64),    # in 512  -> 512
    "Mixed_4e": (112, 144, 288, 32, 64, 64),    # in 512  -> 528
    "Mixed_4f": (256, 160, 320, 32, 128, 128),  # in 528  -> 832
    "Mixed_5b": (256, 160, 320, 32, 128, 128),  # in 832  -> 832
    "Mixed_5c": (384, 192, 384, 48, 128, 128),  # in 832  -> 1024
}
# max pools (window, stride) before these stages, and before the head
_POOLS = {"Conv3d_2b_1x1": ((1, 3, 3), (1, 2, 2)), "Mixed_3b": ((1, 3, 3), (1, 2, 2)),
          "Mixed_4b": ((3, 3, 3), (2, 2, 2)), "Mixed_5b": ((2, 2, 2), (2, 2, 2))}
MIN_FRAMES = 9


class InceptionI3d(nn.Module):
    """Kinetics-400 I3D: (N, T, H, W, C) clips -> (N, num_classes) logits."""

    def __init__(self, num_classes: int = 400, rescale: bool = False, resize: bool = False):
        super().__init__()
        self.rescale, self.resize = rescale, resize
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, channels in _MIXED.items():
            self.add_module(name, InceptionModule(cin, channels))
            cin = getattr(self, name).out_channels
        self.logits = Unit3D(cin, num_classes, use_bn=False, use_relu=False, use_bias=True)

    def forward(self, x):
        n, t, h, w, c = x.shape
        if self.resize and (h, w) != (224, 224):
            x = F.interpolate(x.reshape(n * t, h, w, c).permute(0, 3, 1, 2), size=(224, 224),
                              mode="bilinear", align_corners=False, antialias=False)
            x = x.permute(0, 2, 3, 1).reshape(n, t, 224, 224, c)
        if self.rescale:
            x = x * (2.0 / 255.0) - 1.0
        x = x.permute(0, 4, 1, 2, 3)
        for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3", *_MIXED):
            if name in _POOLS:
                x = _max_pool_3d(x, *_POOLS[name])
            x = getattr(self, name)(x)
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)  # VALID
        return self.logits(x).mean(dim=(2, 3, 4))


def seed_weights(model: nn.Module, seed: int) -> None:
    """Conv kernels N(0, 1/fan_in) (the JAX init's lecun-normal scale),
    biases 0; BatchNorm at identity (weight 1, bias 0, mean 0, var 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if p.dim() == 5:
                p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
            elif name.endswith("conv3d.bias"):
                p.zero_()


def load_i3d_weights(model: InceptionI3d, state_dict):
    """A pytorch-i3d ``state_dict`` (or this module's) into ``model``;
    (missing, unexpected) keys, ``num_batches_tracked`` not counted."""
    sd = {k.removeprefix("module.").removeprefix("i3d."): v for k, v in state_dict.items()}
    result = model.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    return missing, list(result.unexpected_keys)


def make_i3d_feature_fn(state_dict=None, seed: int = 0, resize: bool = False,
                        device=None) -> Callable[[np.ndarray], np.ndarray]:
    """An FVD ``feature_fn``: (N, T, H, W, C) clips in [-1, 1] -> (N, 400)
    numpy.  ``resize=True`` is needed below 224 x 224.  Without a
    ``state_dict`` the net runs on seeded weights, with a warning."""
    device = resolve_device(device)
    model = InceptionI3d(resize=resize)
    if state_dict is None:
        print("WARNING: I3D running with RANDOM weights (no i3d asset supplied); "
              "FVD values are not comparable to the reference.")
        seed_weights(model, seed)
    else:
        missing, _ = load_i3d_weights(model, state_dict)
        if missing:
            print("i3d missing keys:", missing[:5], "...")
    model.to(device).eval()

    @torch.inference_mode()
    def feature_fn(videos) -> np.ndarray:
        if videos.shape[1] < MIN_FRAMES:
            raise ValueError(f"I3D takes at least {MIN_FRAMES} frames a clip, got "
                             f"{videos.shape[1]}")
        x = torch.as_tensor(videos, dtype=torch.float32, device=device)
        return model(x).float().cpu().numpy()

    return feature_fn

