"""Image-folder data pipeline.

Port of ``vqvae_from_gaussian_vae_tpu/data/dataset.py`` onto the port's
registry (the JAX module imports the JAX package's registry, and so jax).
It runs on the host and launches no kernel.

``SimpleDataset``: a recursive JPEG / jpg / png glob, or a .txt file list;
each item is resized on its shorter side, center-cropped and scaled to
[-1, 1]: ``{"img": (H, W, 3) float32, "fpath": str}``.

``ImageDataModuleFromConfig``: batched loaders with threaded prefetch (a
decode error is raised to the consumer, where the JAX loader's thread ends
the epoch early).  The train loader shuffles with ``default_rng(seed + epoch)`` and drops its last
partial batch; every loader takes ``(shard_id, num_shards)``.  With
``use_native`` the C++ decoder of ``native/`` serves ``SimpleDataset``
splits when it builds (``data/native_loader.py``), else the Python loader
does; ``loader_kind`` says which one the last loader is.  Batches are numpy,
``{"img": (B, H, W, 3) float32, "fpath": [str]}`` and, where the items carry
clips (``data/video.py``), ``"video": (B, T, H, W, 3)``: the trainer moves
them to the device.
"""

from __future__ import annotations

import glob
import queue as queue_mod
import threading
from typing import Dict, Iterator, Optional

import numpy as np
from PIL import Image

from vqvae_from_gaussian_vae_tpu_torch.utils.config import instantiate_from_config


def load_image(fpath: str, image_size: int) -> np.ndarray:
    """Resize the shorter side to image_size, center-crop, scale to [-1, 1]."""
    img = Image.open(fpath).convert("RGB")
    w, h = img.size
    scale = image_size / min(w, h)
    nw, nh = max(image_size, round(w * scale)), max(image_size, round(h * scale))
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


class SimpleDataset:
    """Files of a folder (recursive) or of a .txt list."""

    def __init__(self, root: str, image_size: int):
        self.image_size = image_size
        if root.endswith(".txt"):
            with open(root) as f:
                self.fpaths = [line.strip("\n") for line in f.readlines()]
        else:
            self.fpaths = sorted(glob.glob(root + "/**/*.JPEG", recursive=True))
            self.fpaths += sorted(glob.glob(root + "/**/*.jpg", recursive=True))
            self.fpaths += sorted(glob.glob(root + "/**/*.png", recursive=True))
        if not self.fpaths:
            raise ValueError(f"File list is empty. Check the root ({root}).")

    def __len__(self) -> int:
        return len(self.fpaths)

    def __getitem__(self, index: int) -> Dict:
        fpath = self.fpaths[index]
        return {"img": load_image(fpath, self.image_size), "fpath": fpath}


class _PrefetchLoader:
    """Threaded batch loader: a pool of threads decodes, a bounded queue
    holds ``prefetch`` batches ahead of the consumer."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, num_workers: int = 8,
                 prefetch: int = 4, drop_last: bool = True, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.indices = np.arange(len(dataset))[shard_id::num_shards]

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        order = np.array(self.indices)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1

        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]
        if not self.drop_last and nb * self.batch_size < len(order):
            batches.append(order[nb * self.batch_size:])

        out_q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failed = []

        def put(item) -> bool:
            """Queue item unless the consumer has stopped; False if it has."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    pass
            return False

        def worker():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        items = list(pool.map(self.dataset.__getitem__, map(int, batch_idx)))
                        batch = {"img": np.stack([it["img"] for it in items]),
                                 "fpath": [it["fpath"] for it in items]}
                        if "video" in items[0]:  # clip datasets (data/video.py)
                            batch["video"] = np.stack([it["video"] for it in items])
                        if not put(batch):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                failed.append(e)
            finally:
                put(None)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    if failed:
                        raise failed[0]
                    return
                yield item
        finally:
            stop.set()
            thread.join()


class ImageDataModuleFromConfig:
    """train / validation / test loaders from target/params dataset configs."""

    def __init__(self, batch_size: int, train: Optional[Dict] = None,
                 validation: Optional[Dict] = None, test: Optional[Dict] = None,
                 num_workers: Optional[int] = None, shuffle_test_loader: bool = False,
                 shuffle_val_dataloader: bool = False, prefetch_factor: int = 4, seed: int = 0,
                 use_native: bool = True):
        self.batch_size = batch_size
        self.num_workers = num_workers if num_workers is not None else batch_size * 2
        self.prefetch_factor = prefetch_factor
        self.seed = seed
        self.use_native = use_native
        self.loader_kind: Optional[str] = None  # "native" or "python", of the last loader
        self._shuffle = {"train": True, "validation": shuffle_val_dataloader,
                         "test": shuffle_test_loader}
        self.dataset_configs = {name: cfg for name, cfg in
                                (("train", train), ("validation", validation), ("test", test))
                                if cfg is not None}
        self.datasets: Dict = {}

    def setup(self):
        self.datasets = {k: instantiate_from_config(cfg)
                         for k, cfg in self.dataset_configs.items()}

    def _loader(self, split: str, shard_id: int = 0, num_shards: int = 1):
        if not self.datasets:
            self.setup()
        ds = self.datasets[split]
        kw = dict(shuffle=self._shuffle[split], num_workers=self.num_workers,
                  drop_last=split == "train", seed=self.seed, shard_id=shard_id,
                  num_shards=num_shards)
        if self.use_native and isinstance(ds, SimpleDataset):
            from vqvae_from_gaussian_vae_tpu_torch.data import native_loader

            if native_loader.native_available():
                self.loader_kind = "native"
                return native_loader.NativeLoader(ds.fpaths, ds.image_size, self.batch_size,
                                                  **kw)
        self.loader_kind = "python"
        return _PrefetchLoader(ds, self.batch_size, prefetch=self.prefetch_factor, **kw)

    def train_dataloader(self, **kw):
        return self._loader("train", **kw)

    def val_dataloader(self, **kw):
        return self._loader("validation", **kw)

    def test_dataloader(self, **kw):
        return self._loader("test", **kw)


class StableDataModuleFromConfig:
    """The reference's data module over its private ``sdata`` package; it
    has no counterpart here and raises, as the JAX package's does."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StableDataModuleFromConfig depends on the reference's private "
            "`sdata` package (the reference itself sys.exits without it); "
            "use ImageDataModuleFromConfig instead")
