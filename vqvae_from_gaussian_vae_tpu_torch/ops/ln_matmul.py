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
one TMA + wgmma GEMM body (128 x 256 output tiles walked persistently, a
four-stage ring of x and W boxes, two consumer warpgroups) whose fused
form first writes each row's float32 (mean, rstd) with a statistics pass
into a scratch and then normalises each arrived x tile in shared memory
before the products read it.  ``bm`` is the TPU kernel's row block, the
rows that share one pass over W: here ``bm / 128`` M tiles form a raster
group whose column tiles run together (W's tiles shared through L2); it
does not set the grid, which is the card's SMs (``ln_matmul_plan``).  The
kernels take any positive multiple of 128 and refuse any other with a
``ValueError``.  The wrappers take contiguous CUDA tensors only: x or y
(R, C) bf16 with C a multiple of 32 up to 768, g and b (C,) float32, W (C,
N) bf16 with N a multiple of 8, wb (N,) float32.  Neither has a backward.

The plain versions beside them compute the same functions with the same
roundings in float32 PyTorch; the CPU tests hold them to the JAX lab's
Pallas bodies, and the card holds the kernels to them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

EPS = 1e-5
# the body's tiling (csrc/ln_matmul.cu kBM, kBN, kBK, kStages): one tiling
# for both entries
TILE_M, TILE_N, TILE_K, STAGES = 128, 256, 64, 4
MAX_C = 768
SMS = 132  # an H100's SMs; the kernel reads the card's own count


def smem_bytes() -> int:
    """Shared memory of one block: the ring of x and W boxes, the staged
    half output tile, the ring's full and empty barriers, alignment slack
    (``kSmem`` of ``csrc/ln_matmul.cu``)."""
    stage = TILE_M * TILE_K * 2 + TILE_N * TILE_K * 2
    return STAGES * stage + TILE_M * TILE_N + 2 * STAGES * 8 + 1024


@dataclass(frozen=True)
class LnMatmulPlan:
    """One launch of the GEMM body on (R, C) @ (C, N) with row block bm:
    ``group`` M tiles a raster group, the tile counts, the persistent grid."""
    group: int
    m_tiles: int
    n_tiles: int
    k_steps: int
    tiles: int
    grid: int
    smem: int


def check_tiling(bm: int) -> None:
    """Raise unless ``bm`` is a row block the kernels take."""
    if bm <= 0 or bm % TILE_M:
        raise ValueError(f"row block bm={bm} is not compiled: the kernels group {TILE_M}-row "
                         f"tiles, so bm is a positive multiple of {TILE_M} ({TILE_M}, "
                         f"{2 * TILE_M}, {4 * TILE_M}, {8 * TILE_M}, ...)")


def check_shape(r: int, c: int, n: int) -> None:
    """Raise unless the kernels take (R, C) @ (C, N)."""
    if c % 32 or not 0 < c <= MAX_C or n % 8 or n <= 0 or r <= 0:
        raise ValueError(f"(R, C) @ (C, N) = ({r}, {c}) @ ({c}, {n}) unsupported (C a multiple "
                         f"of 32 up to {MAX_C}, N a multiple of 8)")


def ln_matmul_plan(rows: int, c: int, n: int, bm: int, sms: int = SMS) -> LnMatmulPlan:
    """The launch ``csrc/ln_matmul.cu`` makes: 128 x 256 output tiles, K
    steps of 64 channels, a grid of ``min(tiles, sms)`` persistent blocks."""
    check_tiling(bm)
    check_shape(rows, c, n)
    m_tiles, n_tiles = -(-rows // TILE_M), -(-n // TILE_N)
    tiles = m_tiles * n_tiles
    return LnMatmulPlan(bm // TILE_M, m_tiles, n_tiles, -(-c // TILE_K), tiles,
                        min(tiles, sms), smem_bytes())


def tile_coords(plan: LnMatmulPlan, t: int) -> tuple:
    """Tile ``t`` of the raster -> (M tile, N tile), as the kernel's
    ``tile_coords``: groups of ``plan.group`` M tiles (the last may have
    fewer), each walked column tile by column tile."""
    span = plan.group * plan.n_tiles
    grp, r = divmod(t, span)
    rows = min(plan.group, plan.m_tiles - grp * plan.group)
    return grp * plan.group + r % rows, r // rows


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
    if w.shape[0] != c:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ w {tuple(w.shape)} unsupported")
    try:
        check_shape(r, c, n)
    except ValueError as e:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ w {tuple(w.shape)}: {e}") from None
    for t, size in ((wb, n), *((a, c) for a in affine)):
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise ValueError(f"{name} takes float32 vectors of the width they scale, got "
                             f"{t.dtype} {tuple(t.shape)} for {size}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    return r, c, n


def ln_matmul_cuda(x, g, b, w, wb, bm: int, eps: float = EPS):
    """Launch the fused kernel (``_pallas_fused``'s function), its tiles in
    raster groups of ``bm`` rows: the statistics pass, then the GEMM."""
    _build.refuse_grad("ln_matmul kernel", x, g, b, w, wb)
    r, c, n = _check("ln_matmul kernel", x, w, wb, g, b)
    check_tiling(bm)
    out = torch.empty((r, n), dtype=torch.bfloat16, device=x.device)
    stats = torch.empty((r, 2), dtype=torch.float32, device=x.device)  # (mean, rstd) a row
    with torch.cuda.device(x.device):
        err = _build.library().gvq_ln_matmul(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), wb.data_ptr(),
            stats.data_ptr(), out.data_ptr(), r, c, n, bm, float(eps), _build.stream_of(x))
    _build.check(err, "gvq_ln_matmul")
    ln_matmul_cuda.launches += 1
    return out


ln_matmul_cuda.launches = 0


def matmul_bias_cuda(y, w, wb, bm: int):
    """Launch the matmul + bias kernel (``_pallas_mm``'s function), its
    tiles in raster groups of ``bm`` rows."""
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
