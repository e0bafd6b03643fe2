"""The LayerNorm-prologue matmul lab's kernels: LN fused into a matmul's
prologue, and the plain matmul + bias.

Replaces the two TPU kernels of ``scripts/exp_ln_matmul.py``, a
microbenchmark that no model calls:

* ``_pallas_fused`` (``:64``, body ``_fused_kernel``) -> ``ln_matmul_cuda``:
  out = bf16(bf16(LN(x) * g + b) @ W + wb), float32 statistics (the
  variance as the mean of (x - mean)^2), float32 sums;
* ``_pallas_mm`` (``:81``, body ``_mm_kernel``) -> ``matmul_bias_cuda``:
  out = bf16(y @ W + wb), float32 sums.

Both are ``csrc/ln_matmul.cu`` (``gvq_ln_matmul``, ``gvq_matmul_bias``):
one wmma body whose block owns ``bm`` rows and every column of them, walked
in 128-row sub-tiles whose normalised rows stay in shared memory.  ``bm``
is the TPU kernel's row block; the kernels take any positive multiple of
the 128-row sub-tile and refuse any other with a ``ValueError``.  The
wrappers take contiguous CUDA tensors only: x or y (R, C) bf16 with C a
multiple of 32 up to 768, g and b (C,) float32, W (C, N) bf16 with N a
multiple of 8, wb (N,) float32.  Neither has a backward.

The plain versions beside them compute the same functions with the same
roundings in float32 PyTorch; the CPU tests hold them to the JAX lab's
Pallas bodies, and the card holds the kernels to them.
"""

from __future__ import annotations

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

EPS = 1e-5
SUB_ROWS = 128  # rows of one resident sub-tile (csrc/ln_matmul.cu kSub)
BN, BK, STAGES = 128, 32, 3  # column tile, K rows of W a stage, W stages
MAX_C = 768


def smem_bytes(c: int) -> int:
    """Shared memory of one block: the sub-tile's rows at pitch C + 8 and the
    W ring (``smem_bytes`` of ``csrc/ln_matmul.cu``)."""
    return SUB_ROWS * (c + 8) * 2 + STAGES * BK * (BN + 8) * 2


def blocks(rows: int, bm: int) -> int:
    """The grid: one block per ``bm`` rows."""
    return -(-rows // bm)


def check_tiling(bm: int) -> None:
    """Raise unless the kernels are compiled for row blocks of ``bm``."""
    if bm <= 0 or bm % SUB_ROWS:
        raise ValueError(f"row block bm={bm} is not compiled: the kernels walk a block's rows "
                         f"in {SUB_ROWS}-row sub-tiles, so bm is a positive multiple of "
                         f"{SUB_ROWS} ({SUB_ROWS}, {2 * SUB_ROWS}, {4 * SUB_ROWS}, "
                         f"{8 * SUB_ROWS}, ...)")


# ---------------------------------------------------------------------------
# plain versions


def layer_norm_rows(x, g, b, eps: float = EPS):
    """bf16(LN(x) * g + b) of (R, C) rows, float32 statistics: the activation
    the fused kernel feeds its product (``_ln_ref`` of the JAX lab)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * g.float() + b.float()).to(x.dtype)


def matmul_bias_plain(y, w, wb):
    """Plain version of the matmul + bias kernel: bf16(y @ W + wb), the
    product of the bf16 values in float32."""
    return (y.float() @ w.float() + wb.float()).to(y.dtype)


def ln_matmul_plain(x, g, b, w, wb, eps: float = EPS):
    """Plain version of the fused kernel: the normalised rows rounded to bf16
    once, then ``matmul_bias_plain``: one rounding of the output."""
    return matmul_bias_plain(layer_norm_rows(x, g, b, eps), w, wb)


def ln_matmul_xla_plain(x, g, b, w, wb, eps: float = EPS):
    """The JAX lab's ``xla`` site, ``(layer_norm(x) @ w + wb).astype(bf16)``:
    the bf16 product rounded, then the float32 bias add rounded again.  It
    differs from ``ln_matmul_plain`` by that second rounding only."""
    mm = (layer_norm_rows(x, g, b, eps).float() @ w.float()).to(x.dtype)
    return (mm.float() + wb.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels


def _check(name: str, x, w, wb, *affine) -> tuple:
    """(R, C, N) of what the kernel takes, else raise."""
    tensors = (x, w, wb, *affine)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dim() != 2 or w.dim() != 2 or x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes (R, C) bf16 rows and a (C, N) bf16 weight, got "
                         f"{x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    (r, c), n = x.shape, w.shape[1]
    if w.shape[0] != c or c % BK or not 0 < c <= MAX_C or n % 8 or n <= 0 or r <= 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ w {tuple(w.shape)} unsupported (C a "
                         f"multiple of {BK} up to {MAX_C}, N a multiple of 8)")
    for t, size in ((wb, n), *((a, c) for a in affine)):
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise ValueError(f"{name} takes float32 vectors of the width they scale, got "
                             f"{t.dtype} {tuple(t.shape)} for {size}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    return r, c, n


def ln_matmul_cuda(x, g, b, w, wb, bm: int, eps: float = EPS):
    """Launch the fused kernel (``_pallas_fused``'s function) with ``bm``
    rows a block."""
    _build.refuse_grad("ln_matmul kernel", x, g, b, w, wb)
    r, c, n = _check("ln_matmul kernel", x, w, wb, g, b)
    check_tiling(bm)
    out = torch.empty((r, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().gvq_ln_matmul(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), wb.data_ptr(),
            out.data_ptr(), r, c, n, bm, float(eps), _build.stream_of(x))
    _build.check(err, "gvq_ln_matmul")
    ln_matmul_cuda.launches += 1
    return out


ln_matmul_cuda.launches = 0


def matmul_bias_cuda(y, w, wb, bm: int):
    """Launch the matmul + bias kernel (``_pallas_mm``'s function) with
    ``bm`` rows a block."""
    _build.refuse_grad("matmul_bias kernel", y, w, wb)
    r, c, n = _check("matmul_bias kernel", y, w, wb)
    check_tiling(bm)
    out = torch.empty((r, n), dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        err = _build.library().gvq_matmul_bias(
            y.data_ptr(), w.data_ptr(), wb.data_ptr(), out.data_ptr(), r, c, n, bm,
            _build.stream_of(y))
    _build.check(err, "gvq_matmul_bias")
    matmul_bias_cuda.launches += 1
    return out


matmul_bias_cuda.launches = 0


def ptxas_of(usage: dict, ln: bool) -> dict:
    """``_build.ptxas_usage``'s entry for ``ln_matmul_kernel<LN>``, or {}
    where the log does not name it."""
    for name, entry in usage.items():
        if f"16ln_matmul_kernelILb{int(ln)}E" in name:
            return entry
    return {}
