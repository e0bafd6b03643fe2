"""Launch wrapper of the GQ search kernel (``csrc/gq_argmax.cu``).

Replaces the TPU kernel ``vqvae_from_gaussian_vae_tpu/ops/gq_pallas.py``
(``gq_argmax_pallas``).  Its plain version is
``ops/gq_search.py:argmax_blocked``; ``gq_search`` picks between the two by
the tensor's device.
"""

from __future__ import annotations

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

_TILE_N = 256      # codes per shared-memory tile in the kernel
_ROWS = 512        # rows per block in the kernel
_TARGET_BLOCKS = 4 * 132  # enough blocks for a few waves on 132 SMs
SUPPORTED_K = (8, 16, 32)


def _chunking(r: int, n: int):
    """(chunk, n_chunks): codes per block along N, a multiple of the tile."""
    row_blocks = -(-r // _ROWS)
    want = max(1, -(-_TARGET_BLOCKS // row_blocks))
    n_chunks = min(want, -(-n // _TILE_N))
    chunk = -(-n // n_chunks)
    chunk = -(-chunk // _TILE_N) * _TILE_N
    return chunk, -(-n // chunk)


def gq_argmax_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argmax_n (A @ B)[r, n] -> (R,) int32 on the card, first maximum kept.

    a: (R, K) float32 CUDA, b: (K, N) float32 CUDA, K in SUPPORTED_K.
    """
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("gq_argmax_cuda takes CUDA tensors on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"gq_argmax_cuda takes float32, got {a.dtype}, {b.dtype}")
    r, k = a.shape
    if b.shape[0] != k or k not in SUPPORTED_K:
        raise ValueError(f"gq_argmax_cuda: K={k} (b {tuple(b.shape)}) not in {SUPPORTED_K}")
    n = b.shape[1]
    a = a.contiguous()
    b = b.contiguous()
    chunk, n_chunks = _chunking(r, n)
    pval = torch.empty((n_chunks, r), dtype=torch.float32, device=a.device)
    pidx = torch.empty((n_chunks, r), dtype=torch.int32, device=a.device)
    out = torch.empty((r,), dtype=torch.int32, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.gvq_gq_argmax(a.data_ptr(), b.data_ptr(), pval.data_ptr(), pidx.data_ptr(),
                                out.data_ptr(), r, n, k, chunk, n_chunks, _build.stream_of(a))
    _build.check(err, "gvq_gq_argmax")
    gq_argmax_cuda.launches += 1
    return out


gq_argmax_cuda.launches = 0
