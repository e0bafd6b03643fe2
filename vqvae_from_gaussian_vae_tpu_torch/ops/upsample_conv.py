"""Fused nearest-x2 upsample + 3x3 conv with GroupNorm statistics, and its
backward.

Replaces the TPU kernels of ``vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py``:
``_upsample_conv_hwbc`` (the forward) and, behind the custom VJP
``upsample_nearest_conv3x3_gn_vjp`` / ``_add_vjp``, ``_upsample_dgrad`` and
``_upsample_wgrad``.  Nearest x2 duplicates pixels, so
the 3x3 same conv of the upsampled image equals four 2x2 phase convs on the
low-resolution input with the tap-group kernels of ``phase_kernels``:

    y[2i+di, 2j+dj] = bias + sum_{a,b} xpad[i+di+a, j+dj+b] . k22[di,dj,a,b]

(xpad: x with a one-pixel zero halo).  An optional residual ``x + add`` is
summed first, rounded to the compute dtype; the op also returns
per-sample per-channel (sum, sum of squares) of the stored output, (B, 2, O).

The backward is the same phase algebra in reverse: the adjoint of the op
is a 4x4 stride-2 conv, which splits into 16 low-resolution taps.  It folds
the statistics cotangent into the output's (float32, then rounded), sums
``dbias``, runs dgrad (dx from the cotangent's phases and k22^T) and wgrad
(dk22, float32), and maps dk22 back to dw through ``phase_kernels_vjp``;
with the deferred add, x and add get the same dx.  ``GVQ_UPSAMPLE_BWD=conv``
(read at each backward, as the JAX package reads it) takes the conv-form
adjoint instead, as JAX's ``_upsample_bwd_conv``: the adjoint of nearest x2
then the 3x3 same conv, in float32 on the unrounded cotangent and the
float32 weight, by autograd (cuDNN on the card; the JAX package computes it
outside any Pallas kernel too).

Layout at this surface is the JAX package's: x (B, H, W, C), weight HWIO
(3, 3, C, O), output (B, 2H, 2W, O).  The CUDA kernels
(``csrc/upsample_conv.cu``, ``csrc/upsample_bwd.cu``; the forward and dgrad
on the Hopper implicit-GEMM body ``csrc/conv_igemm_sm90.cuh``, whose launch
``downsample_conv.igemm_plan("up_fwd" / "up_fwd_add" / "up_dgrad", ...)``
mirrors) run for CUDA tensors;
the plain versions below run for CPU tensors and are what the kernels are
held to on the card.  When a gradient is wanted,
``upsample_nearest_conv3x3_gn`` is a ``torch.autograd.Function``.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops.downsample_conv import (
    channel_stats, check_bf16_cuda, conv_adjoint, igemm_plan, resample_bwd_operands, wgrad_plan)

_GROUPS = {0: ((0,), (1, 2)), 1: ((0, 1), (2,))}  # phase d -> tap rows of group a
# the taps r * 3 + s that k22[di, dj, a, b] sums, in (di, dj, a, b) order and
# each in the order of its sum (rows, then columns); 9 pads to four terms
_PHASE_TERMS = [[3 * r + s for r in _GROUPS[di][a] for s in _GROUPS[dj][bb]] + [9] * (
    4 - len(_GROUPS[di][a]) * len(_GROUPS[dj][bb]))
    for di in (0, 1) for dj in (0, 1) for a in (0, 1) for bb in (0, 1)]


@functools.lru_cache(maxsize=None)
def _phase_terms(device) -> torch.Tensor:
    """``_PHASE_TERMS`` flattened, on `device` once (no copy to the card a call)."""
    return torch.tensor(_PHASE_TERMS, device=device).flatten()


def phase_kernels(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, O) HWIO -> (2, 2, 2, 2, C, O) phase kernels k22[di, dj, a, b],
    the sums of the duplicated-pixel tap groups.

    The sums are taken in float32, term after term, and rounded to w's
    dtype once, all 16 at a time (a handful of launches on the card).
    (The JAX package sums the bf16 weight in bf16; the two agree to bf16
    rounding.)
    """
    wf = w.float().reshape((9,) + tuple(w.shape[2:]))
    wz = torch.cat([wf, torch.zeros_like(wf[:1])])  # tap 9: the zero a short sum pads with
    t = wz.index_select(0, _phase_terms(w.device)).unflatten(0, (16, 4))
    k22 = ((t[:, 0] + t[:, 1]) + t[:, 2]) + t[:, 3]
    return k22.reshape((2, 2, 2, 2) + tuple(w.shape[2:])).to(w.dtype)


def phase_kernels_vjp(dk22: torch.Tensor) -> torch.Tensor:
    """The VJP of ``phase_kernels``: dk22 (2, 2, 2, 2, C, O) -> dw (3, 3, C, O),
    each tap the sum of the phase-kernel gradients whose group holds it
    (float32, as JAX's ``jax.vjp(phase_kernels, ...)``)."""
    dw = torch.zeros((3, 3) + tuple(dk22.shape[-2:]), dtype=torch.float32, device=dk22.device)
    for di in (0, 1):
        for dj in (0, 1):
            for a in (0, 1):
                for bb in (0, 1):
                    for r in _GROUPS[di][a]:
                        for s in _GROUPS[dj][bb]:
                            dw[r, s] += dk22[di, dj, a, bb].float()
    return dw


def upsample_nearest_conv3x3_gn_plain(x, w, bias, add=None):
    """Plain version: the four phase convs in PyTorch ops, float32 math on
    operands rounded to x's dtype (k22 included), output in x's dtype."""
    if add is not None:
        x = x + add
    b, h, wd, _ = x.shape
    o = w.shape[-1]
    k22 = phase_kernels(w.to(x.dtype)).float()
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1))
    bias_f = bias.to(x.dtype).float()
    y = torch.empty((b, o, 2 * h, 2 * wd), dtype=torch.float32, device=x.device)
    for di in (0, 1):
        for dj in (0, 1):
            y[:, :, di::2, dj::2] = F.conv2d(
                xp[:, :, di:di + h + 1, dj:dj + wd + 1],
                k22[di, dj].permute(3, 2, 0, 1), bias_f)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    return y, channel_stats(y)


def upsample_nearest_conv3x3_gn_cuda(x, w, bias, add=None):
    """Launch the kernel: bf16 CUDA tensors, C a multiple of 32, O a multiple
    of 128.  k22 is computed here, once per call, not per block;
    ``igemm_plan("up_fwd" or "up_fwd_add", ...)`` mirrors the launch."""
    _build.refuse_grad("upsample kernel", x, w, bias, add)
    b, h, wd, c = x.shape
    o = w.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"upsample kernel takes bf16 CUDA tensors, got {x.dtype} on {x.device}")
    if tuple(w.shape) != (3, 3, c, o) or c % 32 or o % 128:
        raise ValueError(f"upsample kernel: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if add is not None and (add.shape != x.shape or add.dtype != x.dtype
                            or add.device != x.device):
        raise ValueError("upsample kernel: add must match x")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("upsample kernel: weight and bias must lie on x's device")
    x = _build.kernel_operand(x)
    add = None if add is None else _build.kernel_operand(add)
    k22 = _build.kernel_operand(phase_kernels(w.to(torch.bfloat16)))
    bias_f = _build.kernel_operand(bias.to(torch.bfloat16).float())
    plan = igemm_plan("up_fwd" if add is None else "up_fwd_add", b, h, wd, c, o)
    y = torch.empty((b, 2 * h, 2 * wd, o), dtype=x.dtype, device=x.device)
    partial = torch.empty((b, plan.partials, 2, o), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, o), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_upsample_conv(
            x.data_ptr(), None if add is None else add.data_ptr(), k22.data_ptr(),
            bias_f.data_ptr(), y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            b, h, wd, c, o, _build.stream_of(x))
    _build.check(err, "gvq_upsample_conv")
    upsample_nearest_conv3x3_gn_cuda.launches += 1
    return y, stats


upsample_nearest_conv3x3_gn_cuda.launches = 0


def upsample_dgrad_plain(g, k22):
    """Plain dgrad: the cotangent g (B, 2H, 2W, O) -> dx (B, H, W, C) in g's
    dtype, dx[i, j] = sum over (di, dj, a, b) of g[2(i-dr)+di, 2(j-dc)+dj]
    k22[di, dj, a, b]^T with dr = di+a-1, dc = dj+b-1 (zero outside the
    image): per phase, a 3x3 conv whose taps sit at (1-dr, 1-dc); float32
    math on operands rounded to g's dtype."""
    kf = k22.to(g.dtype).float()
    gf = g.permute(0, 3, 1, 2).float()
    dx = None
    for di in (0, 1):
        for dj in (0, 1):
            frame = torch.zeros((kf.shape[-2], kf.shape[-1], 3, 3), device=g.device)
            for a in (0, 1):
                for bb in (0, 1):
                    frame[:, :, 2 - di - a, 2 - dj - bb] = kf[di, dj, a, bb]
            part = F.conv2d(F.pad(gf[:, :, di::2, dj::2], (1, 1, 1, 1)), frame)
            dx = part if dx is None else dx + part
    return dx.to(g.dtype).permute(0, 2, 3, 1).contiguous()


def upsample_wgrad_plain(x, g):
    """Plain wgrad: dk22 (2, 2, 2, 2, C, O) float32, dk22[di, dj, a, b] =
    sum over low-resolution pixels of x[i+dr, j+dc]^T g[2i+di, 2j+dj]
    (zero outside the image)."""
    _, h, wd, c = x.shape
    o = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dk22 = torch.empty((2, 2, 2, 2, c, o), dtype=torch.float32, device=x.device)
    for di in (0, 1):
        for dj in (0, 1):
            gp = g[:, di::2, dj::2, :].float().reshape(-1, o)
            for a in (0, 1):
                for bb in (0, 1):
                    xs = xp[:, di + a:di + a + h, dj + bb:dj + bb + wd, :].reshape(-1, c)
                    dk22[di, dj, a, bb] = xs.t() @ gp
    return dk22


def upsample_bwd_uses_conv() -> bool:
    """JAX's switch of the upsample backward: ``GVQ_UPSAMPLE_BWD=conv`` takes
    the conv-form adjoint, anything else the dgrad and wgrad kernels."""
    return os.environ.get("GVQ_UPSAMPLE_BWD", "pallas") == "conv"


def upsample_bwd_conv(x, w, g):
    """The conv-form adjoint (JAX ``_upsample_bwd_conv``): (dx, dw) float32
    of nearest x2 then the 3x3 same conv at x (B, H, W, C), w HWIO, against
    the float32 cotangent g (B, 2H, 2W, O)."""
    return conv_adjoint(lambda t, wt: F.conv2d(F.interpolate(t, scale_factor=2.0, mode="nearest"),
                                               wt, padding=1), x, w, g)


def upsample_dgrad_cuda(g, k22):
    """Launch the dgrad kernel: g (B, 2H, 2W, O) contiguous bf16 CUDA, k22
    (2, 2, 2, 2, C, O), O a multiple of 32, C of 8 -> dx (B, H, W, C) bf16.
    The kernel reads k22 as it lies (cast to bf16 where it is not);
    ``igemm_plan("up_dgrad", ...)`` mirrors its launch."""
    _build.refuse_grad("upsample dgrad kernel", g, k22)  # no double backward
    b, h2, w2, o = g.shape
    c = k22.shape[-2]
    check_bf16_cuda("upsample dgrad kernel", g)
    if tuple(k22.shape) != (2, 2, 2, 2, c, o) or k22.device != g.device or h2 % 2 or w2 % 2 \
            or o % 32 or c % 8:
        raise ValueError(f"upsample dgrad kernel: k22 {tuple(k22.shape)} for g {tuple(g.shape)} "
                         "(even 2H, 2W; O % 32 == 0, C % 8 == 0)")
    g = _build.kernel_operand(g)
    k22 = _build.kernel_operand(k22.to(torch.bfloat16))  # as it lies: dgrad's B is K-major
    dx = torch.empty((b, h2 // 2, w2 // 2, c), dtype=g.dtype, device=g.device)
    lib = _build.library()
    with torch.cuda.device(g.device):
        err = lib.gvq_upsample_dgrad(g.data_ptr(), k22.data_ptr(), dx.data_ptr(), b, h2 // 2,
                                     w2 // 2, o, c, _build.stream_of(g))
    _build.check(err, "gvq_upsample_dgrad")
    upsample_dgrad_cuda.launches += 1
    return dx


upsample_dgrad_cuda.launches = 0


def upsample_wgrad_cuda(x, g):
    """Launch the wgrad kernels: x (B, H, W, C) and g (B, 2H, 2W, O)
    contiguous bf16 CUDA, C and O multiples of 8 -> dk22 (2, 2, 2, 2, C, O)
    float32, bit-reproducible."""
    _build.refuse_grad("upsample wgrad kernel", x, g)
    b, h, wd, c = x.shape
    o = g.shape[-1]
    check_bf16_cuda("upsample wgrad kernel", x, g)
    if tuple(g.shape) != (b, 2 * h, 2 * wd, o) or c % 8 or o % 8:
        raise ValueError(f"upsample wgrad kernel: g {tuple(g.shape)} for x {tuple(x.shape)} "
                         "(C % 8 == 0, O % 8 == 0)")
    plan = wgrad_plan(16, b, h, wd, c, o)
    partial = torch.empty((plan.splits, 16, c, o), dtype=torch.float32, device=x.device)
    dk22 = torch.empty((2, 2, 2, 2, c, o), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_upsample_wgrad(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                     dk22.data_ptr(), b, h, wd, c, o, plan.splits,
                                     plan.chunk, _build.stream_of(x))
    _build.check(err, "gvq_upsample_wgrad")
    upsample_wgrad_cuda.launches += 1
    return dk22


upsample_wgrad_cuda.launches = 0


class _UpsampleFn(torch.autograd.Function):
    """The fused upsample with its backward: the forward kernel, then dgrad
    and wgrad on the folded cotangent and the phase-kernel VJP, or the
    conv-form adjoint where ``upsample_bwd_uses_conv`` (JAX ``_up_vjp_fwd`` /
    ``_up_vjp_bwd`` and the ``_add`` pair)."""

    @staticmethod
    def forward(ctx, x, add, w, bias):
        ctx.set_materialize_grads(False)  # unconsumed statistics give g_stats None
        cpu = x.device.type == "cpu"
        y, stats = (upsample_nearest_conv3x3_gn_plain if cpu else upsample_nearest_conv3x3_gn_cuda)(
            x, w, bias, add)
        ctx.save_for_backward(x, add, w, y)
        ctx.bias_dtype = bias.dtype
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, add, w, y = ctx.saved_tensors
        x, g, dbias = resample_bwd_operands(x, add, y, gy, gstats, ctx.bias_dtype)
        if upsample_bwd_uses_conv():
            dx, dw = upsample_bwd_conv(x, w, g)
            dx = dx.to(x.dtype)
        else:
            g = g.to(x.dtype).contiguous()
            k22 = phase_kernels(w)  # float32 sums, rounded to w's dtype, as the forward's
            if x.device.type == "cpu":
                dx, dk22 = upsample_dgrad_plain(g, k22), upsample_wgrad_plain(x, g)
            else:
                dx, dk22 = upsample_dgrad_cuda(g, k22), upsample_wgrad_cuda(x, g)
            dw = phase_kernels_vjp(dk22)
        return dx, (None if add is None else dx), dw.to(w.dtype), dbias


def upsample_nearest_conv3x3_gn(x, w, bias, add=None):
    """(B,H,W,C) -> ((B,2H,2W,O), (B,2,O) float32 stats): the kernel for
    CUDA tensors, the plain version for CPU tensors; differentiable (dgrad
    and wgrad kernels) when a gradient is wanted."""
    if _build.wants_grad(x, w, bias, add):
        return _UpsampleFn.apply(x, add, w, bias)
    if x.device.type == "cpu":
        return upsample_nearest_conv3x3_gn_plain(x, w, bias, add)
    return upsample_nearest_conv3x3_gn_cuda(x, w, bias, add)


def upsample_nearest_conv3x3(x, w, bias):
    """Nearest x2 + 3x3 same conv without the statistics: (B, H, W, C) ->
    (B, 2H, 2W, O).  On a CUDA tensor it launches the fused kernel (and
    drops its statistics); the plain version runs only for a CPU tensor."""
    y, _ = (upsample_nearest_conv3x3_gn_plain if x.device.type == "cpu"
            else upsample_nearest_conv3x3_gn_cuda)(x, w, bias)
    return y
