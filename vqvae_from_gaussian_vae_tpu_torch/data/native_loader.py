"""ctypes binding of the native decode and prefetch runtime
(``native/gvq_loader.cpp``): a C++ thread pool decoding JPEG (DCT-scaled
libjpeg) and PNG into float32 NHWC [-1, 1] batches.

Port of ``vqvae_from_gaussian_vae_tpu/data/native_loader.py``: the same
library, signatures and behaviour.  Nothing is built or loaded on import:
the first call of ``native_available`` (or of a loader) loads
``native/libgvq_loader.so``, building it with ``make -C native`` when it is
missing; when the build fails it prints why, and the data module takes the
Python loader.  This is a host data path; it launches no device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libgvq_loader.so")
_lib: Optional[ctypes.CDLL] = None


def _load_lib(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and build_if_missing:
        src_dir = os.path.dirname(_LIB_PATH)
        if os.path.exists(os.path.join(src_dir, "Makefile")):
            try:
                subprocess.run(["make", "-C", src_dir], check=True, capture_output=True)
            except (subprocess.CalledProcessError, OSError) as e:
                print(f"native loader build failed ({e}); using the Python loader")
                return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.gvq_loader_create.restype = ctypes.c_void_p
    lib.gvq_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.gvq_loader_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.gvq_loader_next.restype = ctypes.c_int
    lib.gvq_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.gvq_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.gvq_decode_one.restype = ctypes.c_int
    lib.gvq_decode_one.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _require_lib() -> ctypes.CDLL:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable (make -C native)")
    return lib


def decode_image(fpath: str, image_size: int) -> np.ndarray:
    """One image through the native decoder -> (H, W, 3) float32 in [-1, 1]."""
    lib = _require_lib()
    out = np.empty((image_size, image_size, 3), np.float32)
    rc = lib.gvq_decode_one(fpath.encode(), image_size,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"native decode failed for {fpath}")
    return out


class NativeLoader:
    """Batched epoch iterator over the C++ thread pool."""

    def __init__(self, fpaths, image_size: int, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = True, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1):
        lib = _require_lib()
        self._lib = lib
        self.fpaths = list(fpaths)[shard_id::num_shards]
        self.image_size = image_size
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.epoch = 0
        arr = (ctypes.c_char_p * len(self.fpaths))(*[p.encode() for p in self.fpaths])
        self._handle = lib.gvq_loader_create(arr, len(self.fpaths), image_size, batch_size,
                                             num_workers, int(shuffle), seed, int(drop_last))

    def __len__(self) -> int:
        n = len(self.fpaths)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        self._lib.gvq_loader_epoch(self._handle, self.epoch)
        self.epoch += 1
        s = self.image_size
        while True:
            out = np.empty((self.batch_size, s, s, 3), np.float32)
            idx = np.empty((self.batch_size,), np.int32)
            got = self._lib.gvq_loader_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if got == 0:
                return
            yield {"img": out[:got], "fpath": [self.fpaths[i] for i in idx[:got]]}

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.gvq_loader_destroy(self._handle)
            self._handle = None
