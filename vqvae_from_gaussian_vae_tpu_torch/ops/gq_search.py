"""Nearest-prior-sample search: the GQ tokenizer's core op.

For each latent row r with posterior N(mu_r, diag(std_r^2)) and each codebook
entry c_n the reference scores

    score[r, n] = sum_d log N(c_nd; mu_rd, std_rd) - beta * sum_d log N(c_nd; 0, 1)

and takes argmax_n.  Dropping per-row constants and scaling by 2 leaves the
argmax unchanged and turns the scores into one product

    S = A @ B,  A = [2 mu / var, beta - 1 / var]  (R, 2G),  B = [C; C^2]  (2G, N)

whose argmax is taken without ever storing S: a running (best value, best
index) per row, code blocks visited in ascending order and merged with a
strict ``>``, so ties keep the first maximum as torch.argmax does.

``gq_search`` runs the hand-written CUDA kernel (``ops/gq_cuda.py``) for
CUDA tensors and the plain blocked search for CPU tensors; backend
"xla"/"torch" asks for the plain search explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from vqvae_from_gaussian_vae_tpu_torch.ops.gq_cuda import gq_argmax_cuda

KERNEL_BACKENDS = ("auto", "pallas", "cuda")
PLAIN_BACKENDS = ("xla", "torch")


def score_operands(mu: torch.Tensor, std: torch.Tensor, codebook: torch.Tensor, beta: float):
    """(A, B) of the module docstring.

    mu, std: (R, G).  codebook: (N, G).  Returns A (R, 2G) and B (2G, N),
    both float32 and contiguous.
    """
    mu = mu.float()
    std = std.float()
    c = codebook.float()
    ivar = 1.0 / (std * std)
    a = torch.cat([2.0 * mu * ivar, beta - ivar], dim=-1).contiguous()
    b = torch.cat([c, c * c], dim=-1).t().contiguous()
    return a, b


def argmax_blocked(a: torch.Tensor, b: torch.Tensor, block_r: int = 1024,
                   block_n: int = 4096) -> torch.Tensor:
    """Plain version of the search kernel: argmax_n (A @ B)[r, n] -> (R,)
    int32, one (block_r, block_n) score tile at a time, first maximum kept.
    The product runs in float32 (callers on the card turn TF32 off)."""
    r, n = a.shape[0], b.shape[1]
    out = torch.empty(r, dtype=torch.int32, device=a.device)
    for r0 in range(0, r, block_r):
        a_blk = a[r0:r0 + block_r]
        best_val = torch.full((a_blk.shape[0],), -float("inf"), device=a.device)
        best_idx = torch.zeros(a_blk.shape[0], dtype=torch.int64, device=a.device)
        for n0 in range(0, n, block_n):
            s = a_blk @ b[:, n0:n0 + block_n]
            blk_val, blk_arg = s.max(dim=1)  # first maximum within the block
            better = blk_val > best_val      # strict: the earlier block keeps a tie
            best_val = torch.where(better, blk_val, best_val)
            best_idx = torch.where(better, blk_arg + n0, best_idx)
        out[r0:r0 + block_r] = best_idx.to(torch.int32)
    return out


def gq_search(mu: torch.Tensor, std: torch.Tensor, codebook: torch.Tensor,
              beta: float = 1.0, backend: str = "auto") -> torch.Tensor:
    """Return (R,) int32 indices of the best codebook entry per row.

    backend "auto" / "pallas" / "cuda": the CUDA kernel for CUDA tensors,
    the plain blocked search for CPU tensors.  "xla" / "torch": the plain
    blocked search on either device.
    """
    a, b = score_operands(mu, std, codebook, beta)
    if backend in KERNEL_BACKENDS:
        if a.device.type == "cpu":
            return argmax_blocked(a, b)
        return gq_argmax_cuda(a, b)
    if backend in PLAIN_BACKENDS:
        return argmax_blocked(a, b)
    raise ValueError(f"unknown gq_search backend {backend!r}")


def gq_scores_reference(mu: np.ndarray, std: np.ndarray, codebook: np.ndarray,
                        beta: float = 1.0) -> np.ndarray:
    """Unreduced (R, N) scores in float64, the literal formula of the module
    docstring: the oracle that decides whether two indices are a near-tie."""
    mu = mu[:, None, :].astype(np.float64)
    std = std[:, None, :].astype(np.float64)
    c = codebook[None, :, :].astype(np.float64)
    log_q = -0.5 * ((c - mu) / std) ** 2 - np.log(std) - 0.5 * np.log(2 * np.pi)
    log_p = -0.5 * c**2 - 0.5 * np.log(2 * np.pi)
    return (log_q - beta * log_p).sum(axis=2)
