"""MNIST and CIFAR-10 toy datasets from local files.

Port of ``vqvae_from_gaussian_vae_tpu/data/toy.py``: readers of the
standard on-disk formats under ``root`` (MNIST idx files, CIFAR-10 python
pickle batches), nothing downloaded.  Items are the image pipeline's
``{"img": (H, W, 3) float32 in [-1, 1], "fpath": str}``, upscaled to
``image_size`` by pixel repetition.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Dict

import numpy as np


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class MNISTDataset:
    """``train-images-idx3-ubyte(.gz)`` or ``t10k-...`` under ``root``."""

    def __init__(self, root: str, image_size: int = 32, split: str = "train"):
        prefix = "train" if split == "train" else "t10k"
        for ext in ("", ".gz"):
            path = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
            if os.path.exists(path):
                break
        else:
            raise FileNotFoundError(f"no MNIST idx files under {root}")
        self.images = _read_idx(path)
        self.image_size = image_size

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int) -> Dict:
        img = self.images[index].astype(np.float32) / 255.0
        s = self.image_size
        if img.shape[0] != s:
            # an integer repetition, then a centred zero pad to image_size
            reps = max(1, s // img.shape[0])
            img = np.repeat(np.repeat(img, reps, 0), reps, 1)
            pad = s - img.shape[0]
            if pad > 0:
                img = np.pad(img, ((pad // 2, pad - pad // 2),) * 2)
            img = img[:s, :s]
        img = np.repeat(img[..., None], 3, axis=-1)
        return {"img": img * 2.0 - 1.0, "fpath": f"mnist/{index}"}


class CIFAR10Dataset:
    """``cifar-10-batches-py`` pickles under ``root`` (or in it)."""

    def __init__(self, root: str, image_size: int = 32, split: str = "train"):
        batch_dir = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(batch_dir):
            batch_dir = root
        names = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
        data = []
        for name in names:
            path = os.path.join(batch_dir, name)
            if not os.path.exists(path):
                raise FileNotFoundError(f"missing CIFAR batch {path}")
            with open(path, "rb") as f:
                data.append(pickle.load(f, encoding="bytes")[b"data"])
        self.images = np.concatenate(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.image_size = image_size

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int) -> Dict:
        img = self.images[index].astype(np.float32) / 255.0
        s = self.image_size
        if s != 32:
            reps = max(1, s // 32)
            img = np.repeat(np.repeat(img, reps, 0), reps, 1)[:s, :s]
        return {"img": img * 2.0 - 1.0, "fpath": f"cifar10/{index}"}
