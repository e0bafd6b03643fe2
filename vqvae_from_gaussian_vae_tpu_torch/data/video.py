"""Video and image clip datasets.

Port of ``vqvae_from_gaussian_vae_tpu/data/video.py`` on the port's image
dataset (the JAX module imports the JAX package).  GIFs and other
multi-frame images decode through PIL; MP4 and WebM need ``imageio`` (with
ffmpeg) and raise a ``RuntimeError`` without it.  Each frame is resized on
its shorter side (bilinear), center-cropped and scaled to [-1, 1] by the
same PIL and numpy operations as the JAX package, so the frames are equal.
A clip shorter than ``num_frames`` repeats its frames from the start.

Items: ``{"video": (T, H, W, 3) float32, "img": the first frame, "fpath":
str}`` for clips; ``ImageDataset`` gives the image dataset's item, with a
``"video"`` of the image repeated ``num_frames`` times when that is above 1.
It runs on the host and launches no kernel.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image, ImageSequence

from vqvae_from_gaussian_vae_tpu_torch.data.dataset import SimpleDataset

VIDEO_EXTS = (".gif", ".GIF", ".mp4", ".MP4", ".webm")


def _resize_crop(frame: Image.Image, size: int) -> np.ndarray:
    w, h = frame.size
    scale = size / min(w, h)
    nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
    frame = frame.convert("RGB").resize((nw, nh), Image.BILINEAR)
    left, top = (nw - size) // 2, (nh - size) // 2
    arr = np.asarray(frame.crop((left, top, left + size, top + size)), np.float32)
    return arr / 127.5 - 1.0


def load_video(fpath: str, image_size: int, num_frames: int, frame_stride: int = 1) -> np.ndarray:
    """(T, H, W, 3) float32 in [-1, 1]: every ``frame_stride``-th frame."""
    ext = os.path.splitext(fpath)[1].lower()
    frames: List[np.ndarray] = []
    if ext == ".gif":
        with Image.open(fpath) as img:
            for i, frame in enumerate(ImageSequence.Iterator(img)):
                if i % frame_stride:
                    continue
                frames.append(_resize_crop(frame, image_size))
                if len(frames) >= num_frames:
                    break
    else:
        try:
            import imageio.v3 as iio
        except ImportError as e:
            raise RuntimeError(
                f"decoding {ext} needs imageio+ffmpeg, unavailable in this "
                f"environment; use GIF clips or image folders"
            ) from e
        for i, frame in enumerate(iio.imiter(fpath)):
            if i % frame_stride:
                continue
            frames.append(_resize_crop(Image.fromarray(frame), image_size))
            if len(frames) >= num_frames:
                break
    if not frames:
        raise ValueError(f"no frames decoded from {fpath}")
    while len(frames) < num_frames:  # loop-pad short clips
        frames.append(frames[len(frames) % max(len(frames), 1)])
    return np.stack(frames[:num_frames])


class ImageDataset(SimpleDataset):
    """Stills, each optionally repeated into a ``num_frames`` clip."""

    def __init__(self, root: str, image_size: int, num_frames: int = 1):
        super().__init__(root, image_size)
        self.num_frames = num_frames

    def __getitem__(self, index: int) -> Dict:
        item = super().__getitem__(index)
        if self.num_frames > 1:
            item["video"] = np.repeat(item["img"][None], self.num_frames, axis=0)
        return item


class VideoDataset:
    """Clips of a folder (recursive, by ``exts``) or of a .txt file list."""

    def __init__(self, root: str, image_size: int, num_frames: int = 16,
                 frame_stride: int = 1, exts: Optional[List[str]] = None):
        self.image_size = image_size
        self.num_frames = num_frames
        self.frame_stride = frame_stride
        exts = tuple(exts) if exts else VIDEO_EXTS
        if root.endswith(".txt"):
            with open(root) as f:
                self.fpaths = [line.strip("\n") for line in f.readlines()]
        else:
            self.fpaths = []
            for ext in exts:
                self.fpaths += sorted(glob.glob(root + f"/**/*{ext}", recursive=True))
        if not self.fpaths:
            raise ValueError(f"Clip list is empty. Check the root ({root}).")

    def __len__(self) -> int:
        return len(self.fpaths)

    def __getitem__(self, index: int) -> Dict:
        fpath = self.fpaths[index]
        video = load_video(fpath, self.image_size, self.num_frames, self.frame_stride)
        return {"video": video, "img": video[0], "fpath": fpath}
