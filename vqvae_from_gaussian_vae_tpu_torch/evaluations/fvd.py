"""Frechet Video Distance.

Port of ``vqvae_from_gaussian_vae_tpu/evaluations/fvd.py``: the Frechet
distance (``evaluations/fid.py``, on the host) between two sets of I3D
logits (``evaluations/i3d.py``), or of any ``feature_fn`` mapping (N, T, H,
W, C) clip batches to (N, D) features.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from vqvae_from_gaussian_vae_tpu_torch.evaluations.fid import fid_from_features


def fvd_from_features(feats_real: np.ndarray, feats_fake: np.ndarray) -> float:
    return fid_from_features(feats_real, feats_fake)


def compute_fvd(videos_real: Iterable, videos_fake: Iterable,
                feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                i3d_state_dict=None, device=None) -> float:
    """FVD between two iterables of (N, T, H, W, C) clip batches in [-1, 1].
    Without ``feature_fn`` the I3D runs on ``device`` (None: the CUDA
    device), on ``i3d_state_dict`` or, with none, on seeded weights."""
    if feature_fn is None:
        from vqvae_from_gaussian_vae_tpu_torch.evaluations.i3d import make_i3d_feature_fn

        feature_fn = make_i3d_feature_fn(i3d_state_dict, device=device)
    fr = np.concatenate([np.asarray(feature_fn(v)) for v in videos_real])
    ff = np.concatenate([np.asarray(feature_fn(v)) for v in videos_fake])
    return fvd_from_features(fr, ff)
