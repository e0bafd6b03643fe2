"""Training logs: CSV (and W&B) scalars and image grids.

Port of ``vqvae_from_gaussian_vae_tpu/utils/loggers.py``: the same CSV file
(a ``step`` and ``time`` column, the header widened and the file rewritten
when new keys appear), the same grids and image file names
(``images/<split>/<key>_gs-<step:06>.png``) and the same ImageLogger
schedule (every ``batch_frequency`` steps, plus the 2^n warm-up steps).
``WandbLogger`` needs the ``wandb`` package and raises ImportError without
it.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class CSVLogger:
    """Rows of scalars; a row with new keys rewrites the file with the
    widened header."""

    def __init__(self, logdir: str, name: str = "metrics.csv"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, name)
        self._fieldnames = None
        self._rows = []

    def log(self, metrics: Dict[str, float], step: int):
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._rows.append(row)
        extra = [k for k in row if not self._fieldnames or k not in self._fieldnames]
        if self._fieldnames is None or extra:
            self._fieldnames = (self._fieldnames or []) + (
                extra if self._fieldnames else list(row))
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
                w.writeheader()
                w.writerows(self._rows)
        else:
            with open(self.path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
                w.writerow(row)


class WandbLogger:
    """Scalars and image grids to Weights & Biases."""

    def __init__(self, project: str, name: str, config: Optional[dict] = None):
        try:
            import wandb
        except ImportError as e:
            raise ImportError("--wandb needs the `wandb` package, which is not installed; "
                              "the CSV log (metrics.csv) is always written") from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, config=config)

    def log(self, metrics: Dict[str, float], step: int):
        self._wandb.log({k: float(v) for k, v in metrics.items()}, step=step)

    def log_images(self, images: Dict[str, np.ndarray], step: int, split: str = "train"):
        self._wandb.log({f"{split}/{k}": self._wandb.Image(g) for k, g in images.items()},
                        step=step)


def _to_uint8_grid(images: np.ndarray, n_rows: int = 2) -> np.ndarray:
    """(N, H, W, C) in [-1, 1] -> one uint8 grid image, row-major."""
    n, h, w, c = images.shape
    cols = max(1, (n + n_rows - 1) // n_rows)
    grid = np.full((n_rows * h, cols * w, c), 255, np.uint8)
    imgs = np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    return grid


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class ImageLogger:
    """Grids of the engine's ``log_images`` on the trainer's schedule."""

    def __init__(self, batch_frequency: int = 1000, max_images: int = 8,
                 increase_log_steps: bool = True, log_first_step: bool = True,
                 disabled: bool = False, enable_autocast: bool = False,
                 log_images_kwargs: Optional[dict] = None, clamp: bool = True):
        del enable_autocast, clamp  # accepted so the reference's callback configs load
        self.batch_frequency = batch_frequency
        self.max_images = max_images
        self.disabled = disabled
        self.log_first_step = log_first_step
        self.log_images_kwargs = log_images_kwargs or {}
        # the 2^n warm-up steps below batch_frequency
        self.log_steps = ([2 ** n for n in range(int(np.log2(batch_frequency)) + 1)]
                          if increase_log_steps else [])

    def should_log(self, step: int) -> bool:
        if self.disabled:
            return False
        if step == 0:
            return self.log_first_step
        return step % self.batch_frequency == 0 or step in self.log_steps

    def log_images(self, engine, batch, step: int, logdir: str, split: str = "train",
                   extra_images: Optional[dict] = None):
        from PIL import Image

        out_dir = os.path.join(logdir, "images", split)
        os.makedirs(out_dir, exist_ok=True)
        small = {engine.input_key: batch[engine.input_key][:self.max_images]}
        log = engine.log_images(small, **self.log_images_kwargs)
        if extra_images:
            log.update(extra_images)
        n_rows = self.log_images_kwargs.get("n_rows", 2)
        grids = {}
        for key, imgs in log.items():
            grid = _to_uint8_grid(_numpy(imgs), n_rows=n_rows)
            Image.fromarray(grid.squeeze()).save(os.path.join(out_dir, f"{key}_gs-{step:06}.png"))
            grids[key] = grid
        return grids
