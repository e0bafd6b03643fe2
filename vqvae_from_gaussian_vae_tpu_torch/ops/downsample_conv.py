"""Fused stride-2 3x3 downsample conv with GroupNorm statistics, and its
backward.

Replaces the TPU kernels of ``vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py``:
``_downsample_conv`` (the forward) and, behind the custom VJP
``downsample_conv3x3_gn_vjp`` / ``_add_vjp``, ``_downsample_dgrad`` and
``_downsample_wgrad``.  The op: (0,1) zero pad (one row at the bottom, one
column at the right), stride-2 3x3 conv, bias, with an optional residual
``x + add`` summed first (rounded to the compute dtype), and per-sample
per-channel (sum, sum of squares) of the output as stored in the compute
dtype, shaped (B, 2, O), for the consumer's GroupNorm.

The backward folds the statistics cotangent into the output's in float32,
``ybar = g_y + g_sum + 2 y g_sumsq`` on the stored y, sums ``dbias`` from
it, rounds it to the compute dtype, and runs dgrad (the 4 parity phases of
shifted ``ybar w^T``) and wgrad (the (3, 3, C, O) float32 weight gradient);
with the deferred add, x and add get the same dx.  ``GVQ_DOWNSAMPLE_BWD=conv``
(read at each backward, as the JAX package reads it) takes the conv-form
adjoint instead, as JAX's ``_downsample_bwd_conv``: the adjoint of the
padded stride-2 conv in float32 on the unrounded cotangent and the float32
weight, by autograd (cuDNN on the card; the JAX package computes it outside
any Pallas kernel too).

Layout at this surface is the JAX package's: x and add (B, H, W, C), weight
HWIO (3, 3, C, O), output (B, H/2, W/2, O).  The CUDA kernels
(``csrc/downsample_conv.cu``, ``csrc/downsample_bwd.cu``; the forward and
dgrad on the Hopper implicit-GEMM body ``csrc/conv_igemm_sm90.cuh``, whose
launch ``igemm_plan`` mirrors) run for CUDA tensors; the plain versions
below run for CPU tensors and are what the kernels are held to on the
card.  When a gradient is wanted,
``downsample_conv3x3_gn`` is a ``torch.autograd.Function``.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.ops import _build


def channel_stats(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2, C) float32 (sum, sum of squares) over H, W."""
    yf = y.float()
    return torch.stack([yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))], dim=1)


def resample_bwd_operands(x, add, y, gy, gstats, bias_dtype):
    """The backward's operands shared by both resamples: the input as the
    forward's kernel convolved it (x + add, rounded); the cotangent of y,
    ``gy + g_sum + 2 y g_sumsq`` in float32 on the stored y where the
    (B, 2, O) statistics were consumed (the dgrad and wgrad kernels take it
    rounded to x's dtype, the conv form as it is); and dbias, its float32
    sum.  gy or gstats is None where unused."""
    if add is not None:
        x = (x.float() + add.float()).to(x.dtype)
    g = torch.zeros(y.shape, dtype=torch.float32, device=y.device) if gy is None else gy.float()
    if gstats is not None:
        gs = gstats.float()
        g = g + gs[:, 0, None, None, :] + 2.0 * y.float() * gs[:, 1, None, None, :]
    return x.contiguous(), g, g.sum(dim=(0, 1, 2)).to(bias_dtype)


def conv_adjoint(conv, x, w, g):
    """(dx, dw) float32 of the linear map ``conv(x, w)`` (NCHW in, NCHW out,
    w OIHW) at (x, w), against the NHWC float32 cotangent g, by autograd on
    float32 copies: the conv-form resample backward."""
    with torch.enable_grad():
        xf = x.detach().float().permute(0, 3, 1, 2).requires_grad_()
        wf = w.detach().float().permute(3, 2, 0, 1).requires_grad_()
        dx, dw = torch.autograd.grad(conv(xf, wf), (xf, wf), g.permute(0, 3, 1, 2))
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


# the weight-gradient body's launch (csrc/conv_wgrad.cuh): a block takes a
# 128 x tile_o (C, O) tile of one tap and a run of K steps, each one spatial
# tile of 64 pixels
WGRAD_TILE_C = 128
WGRAD_STEP_PIXELS = 64
SMS = 132


class WgradPlan(NamedTuple):
    splits: int         # fixed runs of K steps, summed in ascending order
    chunk: int          # K steps per split (the last may have fewer)
    tile_h: int         # a K step: tile_h x tile_w pixels of one sample's grid
    tile_w: int
    steps: int          # K steps over the batch
    tile_o: int         # output channels of a block's tile
    smem: int           # dynamic shared memory of a block, bytes
    blocks_per_sm: int  # blocks the plan's shared memory lets an SM hold


def wgrad_tile_o(o: int) -> int:
    """A block's output-channel tile: 256 where O is a multiple of 256 (one
    block an SM, four 48 KB stages), else 128 (two blocks an SM, three 32 KB
    stages); ``conv_wgrad.cuh`` ``wgrad_tile_o`` is the same rule."""
    return 256 if o % 256 == 0 else 128


def wgrad_smem(tile_o: int) -> int:
    """Bytes of dynamic shared memory a block asks for (``wgrad_smem``):
    the ring, its full and empty barriers, and 1 KB of alignment slack."""
    stages = 4 if tile_o == 256 else 3
    return stages * (2 + tile_o // 64) * WGRAD_STEP_PIXELS * 64 * 2 + 2 * stages * 8 + 1024


def wgrad_tile(mh: int, mw: int):
    """(tile_h, tile_w) of a K step on an (mh, mw) pixel grid: tile_w in
    (64, 32, 16, 8), tile_h = 64 / tile_w, the widest that covers the grid
    with the fewest pixels (``conv_wgrad.cuh`` ``wgrad_tile`` is the same
    rule; the copies zero-fill the overhang)."""
    best = None
    for tw in (64, 32, 16, 8):
        th = WGRAD_STEP_PIXELS // tw
        cover = -(-mh // th) * th * -(-mw // tw) * tw
        if best is None or cover < best[0]:
            best = (cover, th, tw)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def wgrad_plan(taps: int, b: int, mh: int, mw: int, c: int, o: int) -> WgradPlan:
    """The launch of a weight gradient over b samples of an (mh, mw) pixel
    grid: the spatial tile, the output-channel tile, and the split count
    that fills the card's block slots best, by an estimate in K-step times
    (a step of a 128-wide tile with two blocks on its SM, or of a 256-wide
    one alone, takes about the same): the waves of blocks times (steps per
    split + 3 for a block's prologue and epilogue), plus the float32
    partials' round trip through memory at about 0.15 of a step per split
    and 128 x 128 of the tile (fitted to a sweep of split counts on an H100
    at the main path's shapes).  A function of the shape only (cached), so
    a result repeats bit for bit."""
    th, tw = wgrad_tile(mh, mw)
    steps = b * -(-mh // th) * -(-mw // tw)
    tile_o = wgrad_tile_o(o)
    smem = wgrad_smem(tile_o)
    per_sm = 1 if tile_o == 256 else 2
    tiles = taps * -(-c // WGRAD_TILE_C) * -(-o // tile_o)
    best = None
    for want in range(1, min(steps, 256) + 1):
        chunk = -(-steps // want)
        splits = -(-steps // chunk)  # no empty split
        cost = (-(-tiles * splits // (per_sm * SMS)) * (chunk + 3)
                + 0.15 * tile_o / 128 * splits * tiles)
        if best is None or cost < best[0]:
            best = (cost, splits, chunk)
    return WgradPlan(best[1], best[2], th, tw, steps, tile_o, smem, per_sm)


# the implicit-GEMM body's launch (csrc/conv_igemm_sm90.cuh): a block takes
# a 128-pixel spatial tile of one sample's (one phase's) grid and a tile_n
# wide slice of the output channels, over K steps of 64 channels of one tap;
# the modes: the downsample's forward (with the fused add) and dgrad, the
# upsample's forward (with the fused add) and dgrad, and the fused
# GroupNorm + swish conv ("same_gn": an 8 x 16 tile whose (8 + 2) x (16 + 2)
# halo box is transformed once per K step in one of three halo buffers)
IGEMM_PIXELS = 128
IGEMM_MODES = ("fwd", "fwd_add", "dgrad", "up_dgrad", "up_fwd", "up_fwd_add", "same_gn")
IGEMM_GN_TILE = (8, 16)
IGEMM_HALO_STAGES = 3
IGEMM_HALO_BYTES = -(-(IGEMM_GN_TILE[0] + 2) * (IGEMM_GN_TILE[1] + 2) * 128 // 1024) * 1024


class IgemmPlan(NamedTuple):
    tile_h: int         # a block's M tile: tile_h x tile_w pixels of one grid
    tile_w: int
    tiles: int          # spatial tiles a sample (and phase)
    tile_n: int         # output channels of a block's tile
    n_tiles: int
    phases: int         # 1; 4 (dgrad's parity phases, the longest first; the
                        # upsample forward's, next to the N tile)
    stages: int         # the ring's stages
    smem: int           # dynamic shared memory of a block, bytes
    blocks_per_sm: int  # blocks the plan's shared memory and registers let an SM hold
    grid: int           # blocks of the launch
    partials: int       # per-sample statistics partials of the resample forwards (phases x tiles)


def igemm_tile(mh: int, mw: int):
    """(tile_h, tile_w) of a block on an (mh, mw) pixel grid: tile_w in
    (128, 64, 32, 16, 8), tile_h = 128 / tile_w, the widest that covers the
    grid with the fewest pixels (``conv_igemm_sm90.cuh`` ``igemm_tile`` is
    the same rule; the copies zero-fill the overhang)."""
    best = None
    for tw in (128, 64, 32, 16, 8):
        th = IGEMM_PIXELS // tw
        cover = -(-mh // th) * th * -(-mw // tw) * tw
        if best is None or cover < best[0]:
            best = (cover, th, tw)
    return best[1], best[2]


def igemm_tile_n(n: int) -> int:
    """A block's output-channel tile: 256 where N is a multiple of 256, else
    128; ``igemm_tile_n`` in the header is the same rule."""
    return 256 if n % 256 == 0 else 128


def igemm_blocks_per_sm(extra: int, tile_n: int, halo: bool = False) -> int:
    """Blocks an SM (``ig_blocks_per_sm``): two at tile_n 128 with A read
    from shared memory (96 registers a thread), else one (the add's and the
    halo's register-A products need more registers)."""
    return 2 if tile_n == 128 and extra == 0 and not halo else 1


def igemm_stages(extra: int, tile_n: int, halo: bool = False) -> int:
    """Ring stages (``ig_stages``): a stage is the A tile (16 KB), `extra`
    tiles beside it (the add) and tile_n x 64 weights (the weights alone
    beside the halo buffers); three where two blocks share an SM or a stage
    is 64 KB, else four."""
    return 3 if igemm_blocks_per_sm(extra, tile_n, halo) == 2 or (extra and tile_n == 256) else 4


def igemm_smem(extra: int, tile_n: int, halo: bool = False) -> int:
    """Bytes of dynamic shared memory a block asks for (``ig_smem``): the
    ring and its full and empty barriers, the halo buffers and theirs, and
    1 KB of alignment slack."""
    stages = igemm_stages(extra, tile_n, halo)
    stage = (0 if halo else (1 + extra) * IGEMM_PIXELS * 128) + tile_n * 128
    halo_bytes = IGEMM_HALO_STAGES * (IGEMM_HALO_BYTES + 16) if halo else 0
    return stages * stage + halo_bytes + 2 * stages * 8 + 1024


@functools.lru_cache(maxsize=None)
def igemm_plan(mode: str, b: int, h: int, w: int, c: int, o: int) -> IgemmPlan:
    """The launch of the downsample's forward ("fwd", "fwd_add": with the
    fused add) or dgrad ("dgrad") on x (b, h, w, c) and O output channels:
    M is the (h/2, w/2) grid of one sample (and phase), N = o for the
    forward and c for dgrad; a K step is 64 channels of one tap (of c for
    the forward, of o for dgrad).  The upsample's forward ("up_fwd",
    "up_fwd_add") on x (b, h, w, c): M is the (h, w) grid of one sample and
    phase, N = o, K = 4 taps of c, statistics partials over (phase, tile).
    The upsample's dgrad ("up_dgrad") on x (b, h, w, c), the cotangent (b,
    2h, 2w, o): M is the (h, w) grid of one sample, N = c, K = 16 taps of o.
    The fused GroupNorm + swish conv ("same_gn") on x (b, h, w, c): M is
    the (h, w) grid in 8 x 16 tiles, N = o, K = 9 taps of c.  A function of
    the shape only (cached)."""
    if mode not in IGEMM_MODES:
        raise ValueError(f"igemm_plan: mode {mode!r} is not one of {IGEMM_MODES}")
    mh, mw = (h // 2, w // 2) if mode in ("fwd", "fwd_add", "dgrad") else (h, w)
    halo = mode == "same_gn"
    th, tw = IGEMM_GN_TILE if halo else igemm_tile(mh, mw)
    tiles = -(-mh // th) * -(-mw // tw)
    n = c if mode in ("dgrad", "up_dgrad") else o
    tile_n = igemm_tile_n(n)
    n_tiles = -(-n // tile_n)
    extra = 1 if mode in ("fwd_add", "up_fwd_add") else 0
    phases = 4 if mode in ("dgrad", "up_fwd", "up_fwd_add") else 1
    partials = phases * tiles if mode in ("fwd", "fwd_add", "up_fwd", "up_fwd_add") else 0
    return IgemmPlan(th, tw, tiles, tile_n, n_tiles, phases,
                     igemm_stages(extra, tile_n, halo), igemm_smem(extra, tile_n, halo),
                     igemm_blocks_per_sm(extra, tile_n, halo), phases * b * tiles * n_tiles,
                     partials)


def downsample_conv3x3_gn_plain(x, w, bias, add=None):
    """Plain version: the same function in PyTorch ops, float32 math on
    operands rounded to x's dtype, output rounded to x's dtype."""
    if add is not None:
        x = x + add
    xin = F.pad(x.permute(0, 3, 1, 2).float(), (0, 1, 0, 1))
    wt = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xin, wt, bias.to(x.dtype).float(), stride=2)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    return y, channel_stats(y)


def downsample_conv3x3_gn_cuda(x, w, bias, add=None):
    """Launch the kernel: bf16 CUDA tensors, C a multiple of 32, O a multiple
    of 128, even H and W."""
    _build.refuse_grad("downsample kernel", x, w, bias, add)
    b, h, wd, c = x.shape
    o = w.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"downsample kernel takes bf16 CUDA tensors, got {x.dtype} on {x.device}")
    if tuple(w.shape) != (3, 3, c, o) or c % 32 or o % 128 or h % 2 or wd % 2:
        raise ValueError(f"downsample kernel: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if add is not None and (add.shape != x.shape or add.dtype != x.dtype
                            or add.device != x.device):
        raise ValueError("downsample kernel: add must match x")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("downsample kernel: weight and bias must lie on x's device")
    x = _build.kernel_operand(x)
    add = None if add is None else _build.kernel_operand(add)
    w = _build.kernel_operand(w.to(torch.bfloat16))
    bias_f = _build.kernel_operand(bias.to(torch.bfloat16).float())
    plan = igemm_plan("fwd" if add is None else "fwd_add", b, h, wd, c, o)
    y = torch.empty((b, h // 2, wd // 2, o), dtype=x.dtype, device=x.device)
    partial = torch.empty((b, plan.partials, 2, o), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, o), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_downsample_conv(
            x.data_ptr(), None if add is None else add.data_ptr(), w.data_ptr(),
            bias_f.data_ptr(), y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            b, h, wd, c, o, _build.stream_of(x))
    _build.check(err, "gvq_downsample_conv")
    downsample_conv3x3_gn_cuda.launches += 1
    return y, stats


downsample_conv3x3_gn_cuda.launches = 0


def downsample_dgrad_plain(g, w):
    """Plain dgrad: the cotangent g (B, H/2, W/2, O) -> dx (B, H, W, C) in
    g's dtype, the adjoint of the (0,1)-padded stride-2 conv (the 4 parity
    phases of shifted g w[r, s]^T, interleaved; the pad row and column get
    no gradient); float32 math on operands rounded to g's dtype."""
    _, ho, wo, _ = g.shape
    wt = w.to(g.dtype).float().permute(3, 2, 0, 1)  # (O, C, 3, 3)
    dx = F.conv_transpose2d(g.permute(0, 3, 1, 2).float(), wt, stride=2)
    return dx[:, :, :2 * ho, :2 * wo].to(g.dtype).permute(0, 2, 3, 1).contiguous()


def downsample_wgrad_plain(x, g):
    """Plain wgrad: dw (3, 3, C, O) float32, the strided input views
    x[2i+r, 2j+s] (row H and column W the zero pad) against g over every
    pixel."""
    _, h, wd, c = x.shape
    xp = F.pad(x.float(), (0, 0, 0, 1, 0, 1))
    gf = g.float().reshape(-1, g.shape[-1])
    taps = [xp[:, r:r + h:2, s:s + wd:2, :].reshape(-1, c).t() @ gf
            for r in range(3) for s in range(3)]
    return torch.stack(taps).reshape(3, 3, c, -1)


def downsample_bwd_uses_conv() -> bool:
    """JAX's switch of the downsample backward: ``GVQ_DOWNSAMPLE_BWD=conv``
    takes the conv-form adjoint, anything else the dgrad and wgrad kernels."""
    return os.environ.get("GVQ_DOWNSAMPLE_BWD", "pallas") == "conv"


def downsample_bwd_conv(x, w, g):
    """The conv-form adjoint (JAX ``_downsample_bwd_conv``): (dx, dw) float32
    of the (0,1)-padded stride-2 3x3 conv at x (B, H, W, C), w HWIO, against
    the float32 cotangent g (B, H/2, W/2, O)."""
    return conv_adjoint(lambda t, wt: F.conv2d(F.pad(t, (0, 1, 0, 1)), wt, stride=2), x, w, g)


def check_bf16_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous bf16 CUDA tensor on the
    first one's device (what the backward kernels read in place)."""
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != tensors[0].device:
            raise ValueError(f"{name} takes contiguous bf16 CUDA tensors on one device, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def downsample_dgrad_cuda(g, w):
    """Launch the dgrad kernel: g (B, H/2, W/2, O) contiguous bf16 CUDA,
    O a multiple of 32, C a multiple of 8 -> dx (B, H, W, C) bf16."""
    _build.refuse_grad("downsample dgrad kernel", g, w)  # no double backward
    b, ho, wo, o = g.shape
    c = w.shape[2]
    check_bf16_cuda("downsample dgrad kernel", g)
    if tuple(w.shape) != (3, 3, c, o) or w.device != g.device or o % 32 or c % 8:
        raise ValueError(f"downsample dgrad kernel: w {tuple(w.shape)} for g {tuple(g.shape)} "
                         "(O % 32 == 0, C % 8 == 0)")
    g = _build.kernel_operand(g)
    w = _build.kernel_operand(w.to(torch.bfloat16))  # HWIO as it lies: dgrad's B is K-major
    dx = torch.empty((b, 2 * ho, 2 * wo, c), dtype=g.dtype, device=g.device)
    lib = _build.library()
    with torch.cuda.device(g.device):
        err = lib.gvq_downsample_dgrad(g.data_ptr(), w.data_ptr(), dx.data_ptr(), b, ho, wo, o,
                                       c, _build.stream_of(g))
    _build.check(err, "gvq_downsample_dgrad")
    downsample_dgrad_cuda.launches += 1
    return dx


downsample_dgrad_cuda.launches = 0


def downsample_wgrad_cuda(x, g):
    """Launch the wgrad kernels: x (B, H, W, C) and g (B, H/2, W/2, O)
    contiguous bf16 CUDA, C and O multiples of 8 -> dw (3, 3, C, O)
    float32, bit-reproducible."""
    _build.refuse_grad("downsample wgrad kernel", x, g)
    b, h, wd, c = x.shape
    o = g.shape[-1]
    check_bf16_cuda("downsample wgrad kernel", x, g)
    if tuple(g.shape) != (b, h // 2, wd // 2, o) or h % 2 or wd % 2 or c % 8 or o % 8:
        raise ValueError(f"downsample wgrad kernel: g {tuple(g.shape)} for x {tuple(x.shape)} "
                         "(H, W even; C % 8 == 0, O % 8 == 0)")
    plan = wgrad_plan(9, b, h // 2, wd // 2, c, o)
    partial = torch.empty((plan.splits, 9, c, o), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_downsample_wgrad(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                       dw.data_ptr(), b, h, wd, c, o, plan.splits,
                                       plan.chunk, _build.stream_of(x))
    _build.check(err, "gvq_downsample_wgrad")
    downsample_wgrad_cuda.launches += 1
    return dw


downsample_wgrad_cuda.launches = 0


class _DownsampleFn(torch.autograd.Function):
    """The fused downsample with its backward: the forward kernel, then
    dgrad and wgrad on the folded cotangent, or the conv-form adjoint where
    ``downsample_bwd_uses_conv`` (JAX ``_down_vjp_fwd`` / ``_down_vjp_bwd``
    and the ``_add`` pair)."""

    @staticmethod
    def forward(ctx, x, add, w, bias):
        ctx.set_materialize_grads(False)  # unconsumed statistics give g_stats None
        cpu = x.device.type == "cpu"
        y, stats = (downsample_conv3x3_gn_plain if cpu else downsample_conv3x3_gn_cuda)(
            x, w, bias, add)
        ctx.save_for_backward(x, add, w, y)
        ctx.bias_dtype = bias.dtype
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, add, w, y = ctx.saved_tensors
        x, g, dbias = resample_bwd_operands(x, add, y, gy, gstats, ctx.bias_dtype)
        if downsample_bwd_uses_conv():
            dx, dw = downsample_bwd_conv(x, w, g)
            dx = dx.to(x.dtype)
        else:
            g = g.to(x.dtype).contiguous()
            if x.device.type == "cpu":
                dx, dw = downsample_dgrad_plain(g, w), downsample_wgrad_plain(x, g)
            else:
                dx, dw = downsample_dgrad_cuda(g, w), downsample_wgrad_cuda(x, g)
        return dx, (None if add is None else dx), dw.to(w.dtype), dbias


def downsample_conv3x3_gn(x, w, bias, add=None):
    """(B,H,W,C) -> ((B,H/2,W/2,O), (B,2,O) float32 stats): the kernel for
    CUDA tensors, the plain version for CPU tensors; differentiable (dgrad
    and wgrad kernels) when a gradient is wanted."""
    if _build.wants_grad(x, w, bias, add):
        return _DownsampleFn.apply(x, add, w, bias)
    if x.device.type == "cpu":
        return downsample_conv3x3_gn_plain(x, w, bias, add)
    return downsample_conv3x3_gn_cuda(x, w, bias, add)
