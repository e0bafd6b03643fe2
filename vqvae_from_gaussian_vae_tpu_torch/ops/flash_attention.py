"""Flash attention on token-major (B, L, H*D) tensors.

Replaces the TPU kernels of ``vqvae_from_gaussian_vae_tpu/ops/flash_blc.py``:
the unpacked entries (``flash_attention_blc``, reached through the front
door ``sdpa_token_major`` by the UNet's AttnBlock): ``_fwd_call`` at
inference, ``_fwd_res_call`` (the training forward, which also writes the
per-(row, head) log-normaliser z) and ``_bwd_call`` (the backward); and the
packed entries, which read q, k and v in place from the ViT's (B, L, 3C)
QKV projection: ``_fwd_call_packed`` (``flash_attention_qkv`` at
inference), ``_fwd_res_call_packed`` and ``_bwd_call_packed``.  Per head:
softmax(q k^T * scale) v with float32 scores, p rounded to v's dtype before
the P.V product (float32 accumulation), the row sum over the float32 p,
and the normaliser applied at the end.  The backward rebuilds
p = exp(s - z); the packed one writes dq | dk | dv as one (B, L, 3C)
tensor.

``flash_attention`` and ``flash_attention_qkv`` are
``torch.autograd.Function``s when a gradient is wanted (the training
forward, then the backward kernel); a direct launch of a kernel wrapper
raises when a gradient is wanted rather than return a tensor cut off from
autograd.  The public ops take any layout: an operand the kernels cannot
read as it is (not contiguous, or data off 16 bytes) is copied once into a
fresh buffer (``_build.kernel_operand``); the ``*_cuda`` wrappers raise on
it.  The CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``)
run for CUDA tensors; the plain versions below run for CPU tensors and are
what the kernels are held to on the card.

Which path an attention takes is the JAX package's choice, read at call
time as JAX reads it: ``sdpa_token_major`` (and the ViT's attention,
``models/vit.py``) takes the kernel only for bf16 values, a shape that
``flash_supported`` accepts and ``GVQ_DISABLE_FUSED_KERNELS`` not ``1``;
everything else takes the einsum path, on the card too.  ``flash_supported``
is JAX's ``flash_blc_supported`` (L a positive multiple of 128, D a multiple
of 8) without its TPU clause (a legal VMEM tiling) and restricted to the
head dims the Hopper kernels take, forward and backward.  The two gates
differ in two classes of shapes, and only there:

  * D a multiple of 8 but not one of ``SUPPORTED_HEAD_DIMS`` (D = 8, 32, 96,
    ...): JAX runs its kernel, the port the einsum path;
  * shapes whose TPU tiling does not fit VMEM (D = 512, H = 1, L = 4096, for
    one): JAX runs the einsum path, the port its kernel.

The values agree within the bf16 attention bar either way.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (64, 128, 256, 512)  # the kernels' head dims, forward and backward

# the wgmma body's tiling (csrc/flash_fwd_sm90.cuh F9Layout): 128-key K and
# V tiles in a 3-stage ring; a block is one producer warpgroup and
# FWD_WARPGROUPS[D] consumer warpgroups of 64 q rows each
FWD_K_ROWS, FWD_STAGES = 128, 3
FWD_WARPGROUPS = {64: 3, 128: 2}
WGMMA_HEAD_DIMS = tuple(FWD_WARPGROUPS)  # that body's head dims (and the backward's wgmma body's)
# the wide wgmma body (csrc/flash_fwd_sm90_wide.cuh FwLayout) at D = 256 and
# 512: a block owns 64 q rows of one (b, h) against 64-key K and V tiles
# (WIDE_STAGES[D] stages of each); two consumer warpgroups each hold half
# of D of the output, and a producer warpgroup
WIDE_ROWS, WIDE_K_ROWS, WIDE_THREADS = 64, 64, 384
WIDE_STAGES = {256: 2, 512: 1}
WIDE_HEAD_DIMS = tuple(WIDE_STAGES)
FWD_BODIES = ("wgmma", "wgmma_wide")  # FlashFwdPlan.body, as FwdPlan::body 1 and 2
SWIZZLE_COLS = 64  # bf16 columns of one 128-byte swizzle row: a box's inner width
LAYOUTS = ("head_major", "token_major", "packed")
# the backward's wgmma body (csrc/flash_bwd_sm90.cuh, the same head dims): a
# block is two consumer warpgroups of 64 rows (128 keys in the dK/dV kernel,
# 128 q rows in the dQ kernel) and a producer warpgroup; 3-stage rings of
# streamed tiles, BWD_Q_TILE[D] q rows (dK/dV) and BWD_K_TILE[D] keys (dQ)
BWD_ROWS, BWD_STAGES, BWD_THREADS = 128, 3, 384
BWD_Q_TILE = {64: 64, 128: 32}
BWD_K_TILE = {64: 128, 128: 64}
# the wide backward body (csrc/flash_bwd_sm90_wide.cuh BwLayout) at D = 256
# and 512: a block owns WIDE_BWD_ROWS keys (dK/dV) or q rows (dQ) and
# WIDE_BWD_COLS of the head dim's columns, D / WIDE_BWD_COLS blocks (a
# cluster at D = 512) a whole row; its two consumer warpgroups split the
# columns, and both kernels stream WIDE_BWD_TILE-row tiles in
# WIDE_BWD_STAGES stages (kBwRows, kBwShare, kBwTile, kBwStages)
WIDE_BWD_ROWS, WIDE_BWD_COLS, WIDE_BWD_TILE, WIDE_BWD_STAGES = 64, 256, 32, 3
BWD_BODIES = ("wgmma", "wgmma_wide")  # FlashBwdPlan.body, as BwdPlan::body 1 and 2
# the float32 head-major op's split-TF32 bodies (csrc/flash_fwd_f32_sm90.cuh,
# csrc/flash_bwd_f32_sm90.cuh at D = 64 and 128): per kernel and head dim,
# (consumer warpgroups of 64 rows a block, streamed rows a tile, stages).
# The forward's block owns q rows and streams keys, the dK/dV kernel's owns
# keys and streams q rows, the dQ kernel's owns q rows and streams keys.
# Every operand is two float32 planes (TF32 hi and lo) in shared memory, so
# the tiles are small; these are the fastest of the tilings tried on an
# H100 (PERF.md §6)
F32_FWD_TILES = {64: (2, 32, 3), 128: (2, 16, 3)}
F32_DKDV_TILES = {64: (2, 16, 3), 128: (1, 8, 3)}
F32_DQ_TILES = {64: (1, 32, 3), 128: (1, 16, 2)}
F32_HEAD_DIMS = tuple(F32_FWD_TILES)
_F32_TILES = {"fwd": F32_FWD_TILES, "dkdv": F32_DKDV_TILES, "dq": F32_DQ_TILES}
# their wide form at D = 256 and 512 (csrc/flash_fwd_f32_sm90_wide.cuh,
# csrc/flash_bwd_f32_sm90_wide.cuh): a block is one consumer warpgroup of 64
# rows and a producer warpgroup and owns `share` of D's columns, the D /
# share blocks of a row tile a cluster along the grid's z.  Per kernel and
# head dim, (share, streamed rows a tile, stages), as csrc/flash_f32_sm90.cuh
# TwTiles: the fastest of the tilings tried on an H100 (PERF.md §6)
F32_WIDE_TILES = {"fwd": {256: (128, 32, 2), 512: (128, 16, 3)},
                  "dkdv": {256: (64, 16, 3), 512: (128, 8, 2)},
                  "dq": {256: (128, 8, 3), 512: (128, 8, 3)}}
F32_WIDE_HEAD_DIMS = (256, 512)
F32_KERNELS = ("fwd", "dkdv", "dq")
F32_BODIES = ("split_tf32", "split_tf32_wide")  # FlashF32Plan.body, as F32Plan::body 0 and 1
F32_SWIZZLE_COLS = 32  # float32 columns of one 128-byte swizzle row
# the plan's maps, in F32Plan::map's order: "rows" planes (a tensor as it
# lies) and "cols" planes (transposed, rows permuted in 8s: *_qt, *_kt,
# *_vt, *_dot)
F32_MAPS = ("fwd_q", "fwd_k", "fwd_vt", "dkdv_q", "dkdv_k", "dkdv_v", "dkdv_do", "dkdv_qt",
            "dkdv_dot", "dq_q", "dq_k", "dq_v", "dq_do", "dq_kt")


@dataclasses.dataclass(frozen=True)
class TensorMapPlan:
    """One 4-D TMA map: ``offset`` elements from the tensor's base, ``dims``
    innermost first, ``strides`` the byte strides of dims 1..3, ``box`` the
    elements one copy reads along each dim."""

    offset: int
    dims: tuple
    strides: tuple
    box: tuple


@dataclasses.dataclass(frozen=True)
class FlashFwdPlan:
    """The launch of a bf16 flash forward, as ``flash_fwd_plan`` makes it
    and the C entries read it (``as_array``; ``csrc/flash_fwd_sm90.cuh``
    ``FwdPlan``).

    ``body`` is ``"wgmma"`` (``csrc/flash_fwd_sm90.cuh``, D = 64 and 128)
    or ``"wgmma_wide"`` (``csrc/flash_fwd_sm90_wide.cuh``, D = 256 and
    512); a block owns ``q_rows`` q rows of one (b, h) and walks
    ``k_rows``-key tiles in a ring of ``stages``; ``grid`` is (q tiles,
    B * H); ``key_mask``: the last key tile is partial, and its keys past
    Lk score -inf.  ``maps`` are q's, k's and v's tensor maps, whose
    coordinates are (column, row, h, b) where ``row_dim`` is 1
    (head-major) and (column, h, row, b) where it is 2; ``out_strides``
    are o's (b, h, row) strides in elements."""

    body: str
    q_rows: int
    k_rows: int
    stages: int
    grid: tuple
    threads: int
    smem: int
    key_mask: bool
    row_dim: int
    maps: tuple
    out_strides: tuple

    def coords(self, chunk: int, row: int, b: int, h: int) -> tuple:
        """The box origin the producer asks for: columns 64 * chunk.., rows
        row.. of (b, h)."""
        return _coords(self.row_dim, chunk, row, b, h)

    def as_array(self):
        """The plan as the C entries take it: 49 int64 in ``FwdPlan``'s order."""
        vals = [1 + FWD_BODIES.index(self.body), self.q_rows, self.k_rows, self.stages,
                *self.grid, self.threads, self.smem, int(self.key_mask), self.row_dim]
        return _int64s(vals, self.maps, 3, list(self.out_strides), 49)


def _coords(row_dim: int, chunk: int, row: int, b: int, h: int) -> tuple:
    if row_dim == 1:
        return (SWIZZLE_COLS * chunk, row, h, b)
    return (SWIZZLE_COLS * chunk, h, row, b)


def _int64s(head: list, maps: tuple, n_maps: int, tail: list, length: int):
    """head, then each map's offset, dims, strides and box (zeros where the
    body takes no maps), then tail, as a C int64 array of `length`."""
    vals = list(head)
    for m in maps or (TensorMapPlan(0, (0,) * 4, (0,) * 3, (0,) * 4),) * n_maps:
        vals += [m.offset, *m.dims, *m.strides, *m.box]
    vals += tail
    assert len(vals) == length
    return (ctypes.c_longlong * len(vals))(*vals)


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """The launch of a bf16 flash backward, as ``flash_bwd_plan`` makes it
    and the C entries read it (``as_array``; ``csrc/flash_bwd_sm90.cuh``
    ``BwdPlan``).

    ``body`` is ``"wgmma"`` (``csrc/flash_bwd_sm90.cuh``, D = 64 and 128)
    or ``"wgmma_wide"`` (``csrc/flash_bwd_sm90_wide.cuh``, D = 256 and
    512).  The dK/dV kernel's block owns ``kv_rows`` keys of one (b, h)
    and walks ``kv_q_rows``-row q tiles over ``kv_grid`` (key tiles, B *
    H); the dQ kernel's block owns ``q_rows`` q rows and walks
    ``q_k_rows``-key tiles over ``q_grid`` (q tiles, B * H); in both, D /
    ``splits`` of the head dim's columns, ``splits`` blocks (a cluster)
    along the grid's z; both take ``threads`` threads and
    ``kv_smem`` / ``q_smem`` bytes of shared memory.  ``q_mask``: the last
    q tile of the dK/dV kernel is partial (its rows past Lq get p = ds =
    0); ``key_mask``: the last key tile of the dQ kernel is.  ``maps`` are
    q's, k's, v's and do's tensor maps (coordinates as ``FlashFwdPlan``'s,
    by ``row_dim``); a map's box holds ``kv_q_rows`` rows for q and do and
    ``q_k_rows`` for k and v.  ``dq_strides`` and ``dkv_strides`` are the
    outputs' (b, h, row) strides in elements."""

    body: str
    kv_rows: int
    kv_q_rows: int
    q_rows: int
    q_k_rows: int
    stages: int
    kv_grid: tuple
    q_grid: tuple
    threads: int
    kv_smem: int
    q_smem: int
    q_mask: bool
    key_mask: bool
    row_dim: int
    maps: tuple
    dq_strides: tuple
    dkv_strides: tuple
    splits: int

    def coords(self, chunk: int, row: int, b: int, h: int) -> tuple:
        """The box origin the producer asks for: columns 64 * chunk.., rows
        row.. of (b, h)."""
        return _coords(self.row_dim, chunk, row, b, h)

    def as_array(self):
        """The plan as the C entries take it: 71 int64 in ``BwdPlan``'s order."""
        vals = [1 + BWD_BODIES.index(self.body), self.kv_rows, self.kv_q_rows, self.q_rows,
                self.q_k_rows, self.stages, *self.kv_grid, *self.q_grid, self.threads,
                self.kv_smem, self.q_smem, int(self.q_mask), int(self.key_mask), self.row_dim]
        return _int64s(vals, self.maps, 4,
                       [*self.dq_strides, *self.dkv_strides, self.splits], 71)


def wgmma_fwd_smem(d: int) -> int:
    """Shared memory of ``csrc/flash_fwd_sm90.cuh`` (``F9Layout<D>::kSmem``):
    the Q tile, the ring's K and V tiles, the mbarriers and 1024 bytes of
    alignment slack."""
    rows = 64 * FWD_WARPGROUPS[d]
    return (rows + 2 * FWD_STAGES * FWD_K_ROWS) * d * 2 + (1 + 3 * FWD_STAGES) * 8 + 1024


def wide_fwd_smem(d: int) -> int:
    """Shared memory of ``csrc/flash_fwd_sm90_wide.cuh``
    (``FwLayout<D>::kSmem``): the Q tile, the K and V stages, the mbarriers
    (Q full; K full, V full, K empty, V empty a stage) and 1024 bytes of
    alignment slack."""
    stages = WIDE_STAGES[d]
    return (WIDE_ROWS + 2 * stages * WIDE_K_ROWS) * d * 2 + (1 + 4 * stages) * 8 + 1024


def wgmma_bwd_smem(d: int) -> tuple:
    """Shared memory of ``csrc/flash_bwd_sm90.cuh``'s two kernels
    (``B9KvLayout<D>::kSmem``, ``B9QLayout<D>::kSmem``): the block's two
    128-row tiles, the ring's stages (two streamed tiles each; the dK/dV
    kernel's also z and di in float32), the mbarriers and 1024 bytes of
    alignment slack."""
    nq, nk = BWD_Q_TILE[d], BWD_K_TILE[d]
    kv = ((2 * BWD_ROWS + 2 * BWD_STAGES * nq) * d * 2 + BWD_STAGES * 2 * nq * 4
          + (1 + 3 * BWD_STAGES) * 8 + 1024)
    q = (2 * BWD_ROWS + 2 * BWD_STAGES * nk) * d * 2 + (1 + 2 * BWD_STAGES) * 8 + 1024
    return kv, q


def wide_bwd_smem(d: int) -> tuple:
    """Shared memory of ``csrc/flash_bwd_sm90_wide.cuh``'s two kernels
    (``BwLayout<D, true>::kSmem``, ``BwLayout<D, false>::kSmem``): the
    block's two resident 64-row tiles and the ring's stages (two streamed
    tiles each), all of the block's 256 columns; the exchange tile of the
    two warpgroups' float32 partial scores; at D = 512 the two cluster
    tiles of the other block's; the dK/dV kernel's z and di of each stage; the
    mbarriers (three for each stage in the dK/dV kernel, two in the dQ
    kernel, and three more) and 1024 bytes of alignment slack."""
    nt, stages = WIDE_BWD_TILE, WIDE_BWD_STAGES
    common = ((2 * WIDE_BWD_ROWS + 2 * stages * nt) * WIDE_BWD_COLS * 2 + 2 * nt * 128 * 4
              + (2 * nt * 128 * 4 if d > WIDE_BWD_COLS else 0) + 3 * 8 + 1024)
    return common + stages * 2 * nt * 4 + 3 * stages * 8, common + 2 * stages * 8


def _check_plan_shape(name: str, layout: str, b: int, h: int, lq: int, lk: int, d: int,
                      in_stride: int) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"{name}: layout {layout!r} not in {LAYOUTS}")
    if min(b, h, lq, lk) <= 0 or d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: B={b}, H={h}, Lq={lq}, Lk={lk}, D={d} unsupported")
    if layout != "head_major" and (lq != lk or in_stride < h * d):
        raise ValueError(f"{name}: {layout} wants Lq == Lk and a token stride "
                         f">= H*D, got Lq={lq}, Lk={lk}, in_stride={in_stride}")


def _maps(layout: str, b: int, h: int, d: int, tensors: tuple) -> tuple:
    """(row_dim, 4-D maps): one per (length, box rows, element offset, token
    stride) of `tensors`; head-major maps read (D, L, H, B), token-major
    ones (D, H, L, B) at the given token stride, so that a box never leaves
    its (b, h)."""
    if layout == "head_major":
        return 1, tuple(TensorMapPlan(0, (d, n, h, b), (2 * d, 2 * n * d, 2 * h * n * d),
                                      (SWIZZLE_COLS, rows, 1, 1))
                        for n, rows, _, _ in tensors)
    return 2, tuple(TensorMapPlan(off, (d, h, n, b), (2 * d, 2 * st, 2 * n * st),
                                  (SWIZZLE_COLS, 1, rows, 1))
                    for n, rows, off, st in tensors)


@functools.lru_cache(maxsize=None)
def flash_fwd_plan(layout: str, b: int, h: int, lq: int, lk: int, d: int,
                   in_stride: int = 0) -> FlashFwdPlan:
    """The launch of a bf16 flash forward, a function of the shape alone.

    ``layout``: ``"head_major"`` (q (B, H, Lq, D), k and v (B, H, Lk, D),
    contiguous), ``"token_major"`` (q, k, v (B, L, H*D), contiguous) or
    ``"packed"`` (q | k | v read in place from a contiguous (B, L, 3C)
    projection).  ``in_stride`` is the token stride of the inputs (H*D or
    3C; the token-major layouts only, where lq == lk == L).  At D = 64 and
    128 the wgmma body (192 q rows a block at D = 64, 128 at D = 128,
    against 128-key tiles in 3 stages); at D = 256 and 512 the wide wgmma
    body (64 q rows against 64-key tiles, ``WIDE_STAGES[D]`` stages).  Both
    read 4-D maps, (D, L, H, B) head-major and (D, H, L, B) token-major
    with the token stride, so that a box never leaves its (b, h) and TMA's
    zero fill is the ragged edge."""
    _check_plan_shape("flash_fwd_plan", layout, b, h, lq, lk, d, in_stride)
    c = h * d
    out_strides = (h * lq * d, lq * d, d) if layout == "head_major" else (lq * c, d, c)
    if d in WIDE_HEAD_DIMS:
        body, q_rows, k_rows, stages = "wgmma_wide", WIDE_ROWS, WIDE_K_ROWS, WIDE_STAGES[d]
        threads, smem = WIDE_THREADS, wide_fwd_smem(d)
    else:
        body, q_rows, k_rows, stages = "wgmma", 64 * FWD_WARPGROUPS[d], FWD_K_ROWS, FWD_STAGES
        threads, smem = 128 * (FWD_WARPGROUPS[d] + 1), wgmma_fwd_smem(d)
    offsets = (0, c, 2 * c) if layout == "packed" else (0, 0, 0)
    row_dim, maps = _maps(layout, b, h, d,
                          ((lq, q_rows, offsets[0], in_stride),
                           (lk, k_rows, offsets[1], in_stride),
                           (lk, k_rows, offsets[2], in_stride)))
    return FlashFwdPlan(body, q_rows, k_rows, stages, (-(-lq // q_rows), b * h), threads, smem,
                        lk % k_rows != 0, row_dim, maps, out_strides)


@functools.lru_cache(maxsize=None)
def flash_bwd_plan(layout: str, b: int, h: int, lq: int, lk: int, d: int,
                   in_stride: int = 0) -> FlashBwdPlan:
    """The launch of a bf16 flash backward, a function of the shape alone.

    ``layout`` and ``in_stride`` as ``flash_fwd_plan``'s; do is (B, H, Lq,
    D) head-major and (B, L, H*D) contiguous otherwise.  At D = 64 and 128
    the wgmma body: the dK/dV kernel over 128-key blocks streaming
    ``BWD_Q_TILE[D]``-row q tiles, the dQ kernel over 128-row q blocks
    streaming ``BWD_K_TILE[D]``-key tiles, and 4-D maps of q, k, v and do
    whose boxes hold the streamed tile's rows (the 128-row tiles are two or
    four boxes).  At D = 256 and 512 the wide wgmma body: the dK/dV kernel
    over 64-key blocks, the dQ kernel over 64-row q blocks, each block 256
    of the head dim's columns (D / 256 blocks along the grid's z), both
    streaming ``WIDE_BWD_TILE``-row tiles through the same four maps, whose
    boxes hold that many rows (the 64-row tiles are two boxes).  The
    packed outputs dq | dk | dv go into one (B, L, 3C) tensor at the
    input's strides."""
    _check_plan_shape("flash_bwd_plan", layout, b, h, lq, lk, d, in_stride)
    c = h * d
    if layout == "head_major":
        dq_strides, dkv_strides = (h * lq * d, lq * d, d), (h * lk * d, lk * d, d)
    else:
        out = 3 * c if layout == "packed" else c
        dq_strides = dkv_strides = (lq * out, d, out)
    if d in WGMMA_HEAD_DIMS:
        body, rows, nq, nk, stages, splits = ("wgmma", BWD_ROWS, BWD_Q_TILE[d], BWD_K_TILE[d],
                                              BWD_STAGES, 1)
        kv_smem, q_smem = wgmma_bwd_smem(d)
    else:
        body, rows, nq, nk, stages, splits = ("wgmma_wide", WIDE_BWD_ROWS, WIDE_BWD_TILE,
                                              WIDE_BWD_TILE, WIDE_BWD_STAGES, d // WIDE_BWD_COLS)
        kv_smem, q_smem = wide_bwd_smem(d)
    offsets = (0, c, 2 * c) if layout == "packed" else (0, 0, 0)
    row_dim, maps = _maps(layout, b, h, d,
                          ((lq, nq, offsets[0], in_stride), (lk, nk, offsets[1], in_stride),
                           (lk, nk, offsets[2], in_stride), (lq, nq, 0, c)))
    return FlashBwdPlan(body, rows, nq, rows, nk, stages, (-(-lk // rows), b * h),
                        (-(-lq // rows), b * h), BWD_THREADS, kv_smem, q_smem, lq % nq != 0,
                        lk % nk != 0, row_dim, maps, dq_strides, dkv_strides, splits)


@dataclasses.dataclass(frozen=True)
class F32KernelTiles:
    """One kernel of ``FlashF32Plan``: a block owns ``rows`` rows of one (b,
    h) (``rows // 64`` consumer warpgroups) and ``share`` of D's columns,
    and walks ``tile``-row tiles of the other side in a ring of ``stages``;
    ``threads``, ``smem`` bytes of shared memory, ``grid`` (blocks along
    the owned rows, B * H), ``cluster`` = D // share blocks along the
    grid's z, a cluster; ``mask``: the last streamed tile is partial."""

    rows: int
    tile: int
    stages: int
    threads: int
    smem: int
    grid: tuple
    mask: bool
    share: int
    cluster: int

    def as_list(self) -> list:
        return [self.rows, self.tile, self.stages, self.threads, self.smem, *self.grid,
                int(self.mask), self.share, self.cluster]


@dataclasses.dataclass(frozen=True)
class FlashF32Plan:
    """The launch of the float32 head-major op, forward and backward, as
    ``flash_f32_plan`` makes it and the C entries read it (``as_array``;
    ``csrc/flash_f32_sm90.cuh`` ``F32Plan``).

    ``body`` is ``"split_tf32"`` (D = 64 and 128) or ``"split_tf32_wide"``
    (D = 256 and 512, a block a share of D's columns): each product three
    TF32 ``wgmma`` passes, after a pre-pass that writes each operand's
    (hi, lo) planes into a scratch buffer of ``fwd_scratch`` or
    ``bwd_scratch`` floats.  ``fwd``, ``dkdv`` and ``dq`` are the three
    kernels' tiles; ``lq_pitch`` and ``lk_pitch`` the lengths rounded up to
    8, the row length of a "cols" plane.  ``maps`` holds each ``F32_MAPS``
    name's ``TensorMapPlan`` over the scratch (offset in floats, dims
    (cols, rows, 2, B*H), byte strides, box (inner columns, rows, 1, 1));
    the dK/dV and dQ kernels read the same "rows" planes with their own
    boxes.  A "rows" box is 32 columns wide (a block's share is share / 32
    boxes, from its first column), a "cols" box holds the share's rows: one
    map serves every share."""

    body: str
    fwd: F32KernelTiles
    dkdv: F32KernelTiles
    dq: F32KernelTiles
    lq_pitch: int
    lk_pitch: int
    fwd_scratch: int
    bwd_scratch: int
    maps: dict

    def as_array(self):
        """The plan as the C entries take it: 203 int64 in ``F32Plan``'s order."""
        vals = [F32_BODIES.index(self.body), *self.fwd.as_list(), *self.dkdv.as_list(),
                *self.dq.as_list(), self.lq_pitch, self.lk_pitch, self.fwd_scratch,
                self.bwd_scratch]
        return _int64s(vals, tuple(self.maps[n] for n in F32_MAPS), len(F32_MAPS), [], 203)


def f32_tiling(kernel: str, d: int) -> tuple:
    """(warpgroups, streamed rows a tile, stages, share) of a kernel's
    tiling at head dim d."""
    if d in F32_HEAD_DIMS:
        return (*_F32_TILES[kernel][d], d)
    share, tile, stages = F32_WIDE_TILES[kernel][d]
    return 1, tile, stages, share


def f32_smem(kernel: str, d: int) -> int:
    """Shared memory of a split-TF32 kernel at head dim d: ``TfFwdLayout``,
    ``TfKvLayout``, ``TfQLayout`` and at D = 256 and 512 ``TwFwdLayout``,
    ``TwKvLayout``, ``TwQLayout``.  The owned tiles (Q; K and V; Q and dO,
    the block's share of columns), the ring's stages, z and di of each stage
    (dK/dV), at D = 256 and 512 the exchange of the partial scores with the
    cluster's other blocks (two buffers of a slot per other block, 128
    threads' floats each), the mbarriers and 1024 bytes of alignment slack;
    every operand two float32 planes."""
    wg, tile, stages, share = f32_tiling(kernel, d)
    rows, wide = 64 * wg, d in F32_WIDE_HEAD_DIMS
    others = d // share - 1
    if kernel == "fwd":  # Q; K and V^T; S
        body = 8 * rows * share + stages * 16 * tile * share
        floats, bars = tile // 2, 1 + 3 * stages
    elif kernel == "dkdv":  # K, V; q, do, q^T, do^T and z, di; S^T and dP^T
        body = 16 * rows * share + stages * (32 * tile * share + 8 * tile)
        floats, bars = tile, 1 + 3 * stages
    else:  # Q, dO; k, v, k^T; S and dP
        body = 16 * rows * share + stages * 24 * tile * share
        floats, bars = tile, 1 + 2 * stages
    exchange = 2 * others * floats * 4 * 128 if wide else 0
    return body + exchange + (bars + 2 * wide) * 8 + 1024


def _f32_plane(offset: int, bh: int, rows: int, cols: int, box_cols: int,
               box_rows: int) -> TensorMapPlan:
    """The map of (bh, 2, rows, cols) float32 planes at `offset` floats."""
    return TensorMapPlan(offset, (cols, rows, 2, bh), (4 * cols, 4 * rows * cols,
                                                        8 * rows * cols),
                         (box_cols, box_rows, 1, 1))


@functools.lru_cache(maxsize=None)
def flash_f32_plan(b: int, h: int, lq: int, lk: int, d: int) -> FlashF32Plan:
    """The launch of a float32 head-major training call (the forward with z
    and the backward), a function of the shape alone: q (B, H, Lq, D), k
    and v (B, H, Lk, D), contiguous.

    At D = 64 and 128 the split-TF32 bodies, tiles ``F32_FWD_TILES``,
    ``F32_DKDV_TILES``, ``F32_DQ_TILES``; at D = 256 and 512 their wide
    form, tiles ``F32_WIDE_TILES``.  The forward's scratch holds q and k as "rows" planes
    and v^T as a "cols" plane, the backward's q, k, v, do as "rows" planes
    and q^T, k^T, do^T as "cols" planes."""
    if min(b, h, lq, lk) <= 0 or d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_f32_plan: B={b}, H={h}, Lq={lq}, Lk={lk}, D={d} unsupported")
    lqp, lkp = -(-lq // 8) * 8, -(-lk // 8) * 8
    bh = b * h

    def tiles(kernel, owned, streamed):
        wg, tile, stages, share = f32_tiling(kernel, d)
        return F32KernelTiles(64 * wg, tile, stages, 128 * (wg + 1), f32_smem(kernel, d),
                              (-(-owned // (64 * wg)), bh), streamed % tile != 0, share,
                              d // share)

    fwd, dkdv, dq = tiles("fwd", lq, lk), tiles("dkdv", lk, lq), tiles("dq", lq, lk)
    cols = lambda tile: min(tile, F32_SWIZZLE_COLS)  # noqa: E731  a "cols" box's inner width
    maps, at = {}, 0
    # the forward's scratch
    for name, n, box in (("fwd_q", lq, fwd.rows), ("fwd_k", lk, fwd.tile)):
        maps[name] = _f32_plane(at, bh, n, d, F32_SWIZZLE_COLS, box)
        at += 2 * bh * n * d
    maps["fwd_vt"] = _f32_plane(at, bh, d, lkp, cols(fwd.tile), fwd.share)
    fwd_scratch, at = at + 2 * bh * d * lkp, 0
    # the backward's: each "rows" plane read by both kernels with their boxes
    for name, n, kv_box, q_box in (("q", lq, dkdv.tile, dq.rows), ("k", lk, dkdv.rows, dq.tile),
                                   ("v", lk, dkdv.rows, dq.tile), ("do", lq, dkdv.tile, dq.rows)):
        maps["dkdv_" + name] = _f32_plane(at, bh, n, d, F32_SWIZZLE_COLS, kv_box)
        maps["dq_" + name] = _f32_plane(at, bh, n, d, F32_SWIZZLE_COLS, q_box)
        at += 2 * bh * n * d
    for name, pitch, kernel in (("dkdv_qt", lqp, dkdv), ("dq_kt", lkp, dq),
                                ("dkdv_dot", lqp, dkdv)):
        maps[name] = _f32_plane(at, bh, d, pitch, cols(kernel.tile), kernel.share)
        at += 2 * bh * d * pitch
    body = "split_tf32_wide" if d in F32_WIDE_HEAD_DIMS else "split_tf32"
    return FlashF32Plan(body, fwd, dkdv, dq, lqp, lkp, fwd_scratch, at, maps)


def check_aligned(name: str, *tensors) -> None:
    """Raise unless every tensor's data starts on 16 bytes: TMA and the
    16-byte loads of the flash forward bodies read nothing else."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor's data at {t.data_ptr():#x} is not 16-byte "
                             "aligned")


def flash_supported(l: int, num_heads: int, head_dim: int) -> bool:
    """True where the flash kernels take an attention of L tokens and heads
    of ``head_dim`` (JAX's ``flash_blc_supported`` without its TPU VMEM
    clause, restricted to ``SUPPORTED_HEAD_DIMS``; ``num_heads`` is kept for
    its signature and bounds nothing here)."""
    del num_heads
    return l > 0 and l % 128 == 0 and head_dim % 8 == 0 and head_dim in SUPPORTED_HEAD_DIMS


def kernels_disabled() -> bool:
    """``GVQ_DISABLE_FUSED_KERNELS=1``: every site takes its plain path."""
    return os.environ.get("GVQ_DISABLE_FUSED_KERNELS", "") == "1"


def sdpa_uses_flash(dtype, l: int, num_heads: int, head_dim: int) -> bool:
    """The gate of ``sdpa_token_major`` (JAX ``ops/flash_blc.py``'s, less its
    "backend is TPU" clause): bf16 values, a shape ``flash_supported`` takes,
    and the kernels not disabled."""
    return (dtype == torch.bfloat16 and flash_supported(l, num_heads, head_dim)
            and not kernels_disabled())


def flash_attention_plain(q, k, v, sm_scale: float, num_heads: int):
    """Plain version of the kernel; q, k, v (B, L, H*D) -> (B, L, H*D)."""
    b, l, c = q.shape
    d = c // num_heads
    qh = q.reshape(b, l, num_heads, d).float()
    kh = k.reshape(b, l, num_heads, d).float()
    vh = v.reshape(b, l, num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * sm_scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv_sum = 1.0 / p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vh.float())
    o = o * inv_sum.permute(0, 2, 1)[..., None]
    return o.to(v.dtype).reshape(b, l, c)


def flash_attention_res_plain(q, k, v, sm_scale: float, num_heads: int):
    """Plain version of the training forward: (o, z), z (B, H, L) float32,
    z = m + ln(sum) of each row's scaled scores."""
    b, l, c = q.shape
    d = c // num_heads
    s = torch.einsum("bqhd,bkhd->bhqk", q.reshape(b, l, num_heads, d).float(),
                     k.reshape(b, l, num_heads, d).float()) * sm_scale
    m = s.amax(dim=-1)
    z = m + torch.log(torch.exp(s - m[..., None]).sum(dim=-1))
    return flash_attention_plain(q, k, v, sm_scale, num_heads), z


def flash_attention_bwd_plain(q, k, v, o, z, do, sm_scale: float, num_heads: int):
    """Plain version of the backward kernels: (dq, dk, dv), each (B, L, C)
    in q's dtype, from the forward's q, k, v, o, z and the cotangent do of o.

    p = exp(s - z) with no max or sum pass; di = rowsum(do * o) in float32;
    ds = p (do v^T - di) scale rounded to the IO dtype; dq = ds k,
    dk = ds^T q, dv = round(p)^T do, each accumulated in float32."""
    b, l, c = q.shape
    d = c // num_heads
    io = q.dtype
    qf, kf, vf, of, dof = (t.reshape(b, l, num_heads, d).float() for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - z[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    di = (dof * of).sum(dim=-1).permute(0, 2, 1)
    ds = (p * (dp - di[..., None]) * sm_scale).to(io).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(io).float(), dof)
    return tuple(t.reshape(b, l, c).to(io) for t in (dq, dk, dv))


def _check_unpacked(name: str, q, k, v, num_heads: int):
    """Raise on what the unpacked kernels do not take; return (B, L, C, D)."""
    b, l, c = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{name} takes bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or c % num_heads:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} with {num_heads} heads")
    d = c // num_heads
    if d not in SUPPORTED_HEAD_DIMS or l % 64:
        raise ValueError(f"{name}: L={l}, D={d} unsupported "
                         f"(L % 64 == 0, D in {SUPPORTED_HEAD_DIMS})")
    return b, l, c, d


def flash_attention_cuda(q, k, v, sm_scale: float, num_heads: int):
    """Launch the kernel: bf16 CUDA tensors, L a multiple of 64, head dim in
    SUPPORTED_HEAD_DIMS.  The inference form: no z, no gradient."""
    _build.refuse_grad("flash kernel (unpacked)", q, k, v)
    b, l, _, d = _check_unpacked("flash kernel", q, k, v, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_aligned("flash kernel", q, k, v)
    o = torch.empty_like(q)
    plan = flash_fwd_plan("token_major", b, num_heads, l, l, d, num_heads * d)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.gvq_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                b, l, num_heads, d, float(sm_scale), plan.as_array(),
                                _build.stream_of(q))
    _build.check(err, "gvq_flash_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def flash_attention_res_cuda(q, k, v, sm_scale: float, num_heads: int):
    """Launch the unpacked training forward: (o, z) as the plain version."""
    _build.refuse_grad("flash kernel (unpacked training form, outside its autograd Function)",
                       q, k, v)
    b, l, _, d = _check_unpacked("flash kernel (training form)", q, k, v, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_aligned("flash kernel (training form)", q, k, v)
    o = torch.empty_like(q)
    z = torch.empty((b, num_heads, l), dtype=torch.float32, device=q.device)
    plan = flash_fwd_plan("token_major", b, num_heads, l, l, d, num_heads * d)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.gvq_flash_fwd_res(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    z.data_ptr(), b, l, num_heads, d, float(sm_scale),
                                    plan.as_array(), _build.stream_of(q))
    _build.check(err, "gvq_flash_fwd_res")
    flash_attention_res_cuda.launches += 1
    return o, z


flash_attention_res_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, z, do, sm_scale: float, num_heads: int):
    """Launch the unpacked backward kernels: (dq, dk, dv) bf16 (B, L, C)."""
    _build.refuse_grad("flash backward kernel (unpacked)", q, k, v, o, z, do)
    b, l, c, d = _check_unpacked("flash backward kernel", q, k, v, num_heads)
    for name, t, shape, dtype in (("q", q, (b, l, c), q.dtype), ("k", k, (b, l, c), q.dtype),
                                  ("v", v, (b, l, c), q.dtype), ("o", o, (b, l, c), q.dtype),
                                  ("do", do, (b, l, c), q.dtype),
                                  ("z", z, (b, num_heads, l), torch.float32)):
        if t.device != q.device or tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"flash backward kernel: {name} must be a contiguous {shape} "
                             f"{dtype} tensor on {q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    check_aligned("flash backward kernel", q, k, v, o, z, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di = torch.empty((b, num_heads, l), dtype=torch.float32, device=q.device)
    plan = flash_bwd_plan("token_major", b, num_heads, l, l, d, num_heads * d)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.gvq_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                z.data_ptr(), do.data_ptr(), di.data_ptr(), dq.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), b, l, num_heads, d,
                                float(sm_scale), plan.as_array(), _build.stream_of(q))
    _build.check(err, "gvq_flash_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, num_heads):
        if q.device.type == "cpu":
            o, z = flash_attention_res_plain(q, k, v, sm_scale, num_heads)
        else:
            q, k, v = (_build.kernel_operand(t) for t in (q, k, v))
            o, z = flash_attention_res_cuda(q, k, v, sm_scale, num_heads)
        ctx.save_for_backward(q, k, v, o, z)
        ctx.sm_scale, ctx.num_heads = sm_scale, num_heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, z = ctx.saved_tensors
        do = _build.kernel_operand(do)
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd_cuda
        return (*bwd(q, k, v, o, z, do, ctx.sm_scale, ctx.num_heads), None, None)


def flash_attention(q, k, v, sm_scale: float, num_heads: int):
    """(B, L, H*D) x3 -> (B, L, H*D): the kernel for CUDA tensors, the plain
    version for CPU tensors.  When a gradient is wanted, the training
    forward (with z) and the backward run through an autograd Function."""
    if _build.wants_grad(q, k, v):
        return _FlashFn.apply(q, k, v, sm_scale, num_heads)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, num_heads)
    return flash_attention_cuda(*(_build.kernel_operand(t) for t in (q, k, v)), sm_scale,
                                num_heads)


def flash_attention_qkv_plain(qkv, sm_scale: float, num_heads: int):
    """Plain version of the packed kernel; qkv (B, L, 3C), q | k | v along
    channels -> (B, L, C)."""
    q, k, v = qkv.chunk(3, dim=-1)
    return flash_attention_plain(q, k, v, sm_scale, num_heads)


def _check_packed(name: str, qkv, num_heads: int):
    """Raise on what the packed kernels do not take; return (B, L, C, D)."""
    if not qkv.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{name}: shape {tuple(qkv.shape)} with {num_heads} heads")
    b, l, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if d not in SUPPORTED_HEAD_DIMS or l % 64:
        raise ValueError(f"{name}: L={l}, D={d} unsupported "
                         f"(L % 64 == 0, D in {SUPPORTED_HEAD_DIMS})")
    if not qkv.is_contiguous():
        raise ValueError(f"{name} reads q, k, v in place: qkv must be contiguous")
    check_aligned(name, qkv)
    return b, l, c, d


def flash_attention_qkv_cuda(qkv, sm_scale: float, num_heads: int):
    """Launch the packed kernel on the contiguous (B, L, 3C) bf16 projection
    output, in place: no split, no copy.  L a multiple of 64, head dim in
    SUPPORTED_HEAD_DIMS.  The inference form: no z, no gradient."""
    _build.refuse_grad("packed flash kernel (inference form)", qkv)
    b, l, c, d = _check_packed("packed flash kernel", qkv, num_heads)
    o = torch.empty((b, l, c), dtype=qkv.dtype, device=qkv.device)
    plan = flash_fwd_plan("packed", b, num_heads, l, l, d, 3 * c)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = lib.gvq_flash_fwd_qkv(qkv.data_ptr(), o.data_ptr(), b, l, num_heads, d,
                                    float(sm_scale), plan.as_array(), _build.stream_of(qkv))
    _build.check(err, "gvq_flash_fwd_qkv")
    flash_attention_qkv_cuda.launches += 1
    return o


flash_attention_qkv_cuda.launches = 0


def flash_attention_qkv_res_plain(qkv, sm_scale: float, num_heads: int):
    """Plain version of the packed training forward: (o, z) of the
    unpacked one on q | k | v."""
    return flash_attention_res_plain(*qkv.chunk(3, dim=-1), sm_scale, num_heads)


def flash_attention_qkv_res_cuda(qkv, sm_scale: float, num_heads: int):
    """Launch the packed training forward: (o, z) as the plain version."""
    _build.refuse_grad("packed flash kernel (training form, outside its autograd Function)",
                       qkv)
    b, l, c, d = _check_packed("packed flash kernel (training form)", qkv, num_heads)
    o = torch.empty((b, l, c), dtype=qkv.dtype, device=qkv.device)
    z = torch.empty((b, num_heads, l), dtype=torch.float32, device=qkv.device)
    plan = flash_fwd_plan("packed", b, num_heads, l, l, d, 3 * c)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = lib.gvq_flash_fwd_qkv_res(qkv.data_ptr(), o.data_ptr(), z.data_ptr(), b, l,
                                        num_heads, d, float(sm_scale), plan.as_array(),
                                        _build.stream_of(qkv))
    _build.check(err, "gvq_flash_fwd_qkv_res")
    flash_attention_qkv_res_cuda.launches += 1
    return o, z


flash_attention_qkv_res_cuda.launches = 0


def flash_attention_qkv_bwd_plain(qkv, o, z, do, sm_scale: float, num_heads: int):
    """Plain version of the packed backward kernel: dqkv (B, L, 3C) in qkv's
    dtype, the unpacked backward's dq | dk | dv along channels."""
    q, k, v = qkv.chunk(3, dim=-1)
    return torch.cat(flash_attention_bwd_plain(q, k, v, o, z, do, sm_scale, num_heads), dim=-1)


def flash_attention_qkv_bwd_cuda(qkv, o, z, do, sm_scale: float, num_heads: int):
    """Launch the packed backward kernels: dqkv (B, L, 3C) bf16, written
    at channel offsets 0, C and 2C with no concatenation pass."""
    _build.refuse_grad("packed flash backward kernel", qkv, o, z, do)  # no double backward
    b, l, c, d = _check_packed("packed flash backward kernel", qkv, num_heads)
    for name, t, shape, dtype in (("o", o, (b, l, c), qkv.dtype), ("do", do, (b, l, c), qkv.dtype),
                                  ("z", z, (b, num_heads, l), torch.float32)):
        if t.device != qkv.device or tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"packed flash backward kernel: {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {qkv.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    check_aligned("packed flash backward kernel", o, z, do)
    dqkv = torch.empty_like(qkv)
    di = torch.empty((b, num_heads, l), dtype=torch.float32, device=qkv.device)
    plan = flash_bwd_plan("packed", b, num_heads, l, l, d, 3 * c)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = lib.gvq_flash_bwd_qkv(qkv.data_ptr(), o.data_ptr(), z.data_ptr(), do.data_ptr(),
                                    di.data_ptr(), dqkv.data_ptr(), b, l, num_heads, d,
                                    float(sm_scale), plan.as_array(), _build.stream_of(qkv))
    _build.check(err, "gvq_flash_bwd_qkv")
    flash_attention_qkv_bwd_cuda.launches += 1
    return dqkv


flash_attention_qkv_bwd_cuda.launches = 0


class _FlashQKVFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, sm_scale, num_heads):
        if qkv.device.type == "cpu":
            o, z = flash_attention_qkv_res_plain(qkv, sm_scale, num_heads)
        else:
            qkv = _build.kernel_operand(qkv)
            o, z = flash_attention_qkv_res_cuda(qkv, sm_scale, num_heads)
        ctx.save_for_backward(qkv, o, z)
        ctx.sm_scale, ctx.num_heads = sm_scale, num_heads
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, z = ctx.saved_tensors
        do = _build.kernel_operand(do)
        bwd = flash_attention_qkv_bwd_plain if qkv.device.type == "cpu" \
            else flash_attention_qkv_bwd_cuda
        return bwd(qkv, o, z, do, ctx.sm_scale, ctx.num_heads), None, None


def flash_attention_qkv(qkv, sm_scale: float, num_heads: int):
    """(B, L, 3C) -> (B, L, C): the packed kernel for CUDA tensors, the plain
    version for CPU tensors.  When a gradient is wanted, the training
    forward (with z) and the packed backward run through an autograd
    Function."""
    if _build.wants_grad(qkv):
        return _FlashQKVFn.apply(qkv, sm_scale, num_heads)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_plain(qkv, sm_scale, num_heads)
    return flash_attention_qkv_cuda(_build.kernel_operand(qkv), sm_scale, num_heads)


def sdpa_token_major(q, k, v, sm_scale: float = None):
    """softmax(q k^T * sm_scale) v over token-major (B, L, H, D) inputs,
    returning (B, L, H*D).

    Where ``sdpa_uses_flash`` holds and k has q's length, through
    ``flash_attention`` (the kernel on the card); elsewhere (float32, a shape
    the kernels do not take, the kernels disabled, a cross-attention over
    fewer or more keys than queries) the einsum path with a float32 softmax,
    as the JAX package's fallback.  JAX's gate reads q's length alone: on the
    TPU a cross-attention (flux's IP-adapter over its image tokens) would
    fail at its reshape, off the TPU it takes the einsum path, as here.
    """
    b, l, h, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if k.shape[1] == l and sdpa_uses_flash(v.dtype, l, h, d):
        return flash_attention(q.to(v.dtype).reshape(b, l, h * d),
                               k.to(v.dtype).reshape(b, l, h * d),
                               v.reshape(b, l, h * d), sm_scale, h)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(b, l, h * d)
