"""GroupNorm(32) + swish with a hand-written backward, for training.

Replaces the TPU kernel of ``vqvae_from_gaussian_vae_tpu/ops/gn_swish_bwd.py``
(``_gn_swish_bwd_pallas``) behind its custom VJP ``gn_swish``.  The forward
is plain torch (``gn_swish_ref``, the JAX ``_gn_swish_ref`` formula for
formula, on the card too) and keeps the per-(sample, channel) mean and rstd;
the backward recomputes ``dh`` (the cotangent at the GroupNorm output,
through swish) from x and dy instead of storing it:

    xhat = (x - mean) * rstd,  hpre = xhat * gamma + beta
    dh = dy * sig * (1 + hpre * (1 - sig)),   sig = sigmoid(hpre)
    c1 = mean over each group of gamma * dh,  c2 = of gamma * dh * xhat
    dx = (dh * gamma - c1 - xhat * c2) * rstd
    dgamma = sum dh * xhat,  dbeta = sum dh     (float32)

Layout at this surface is the JAX package's: x and dy (B, H, W, C).  The
CUDA kernel (``csrc/gn_swish_bwd.cu``: one cooperative launch, two
streaming passes over x and dy with one grid barrier between them,
``gn_bwd_plan`` sizing it) runs for CUDA tensors; the plain version below
runs for CPU tensors and is what the kernel is held to on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build, grid_sync
from vqvae_from_gaussian_vae_tpu_torch.ops.fused_gn_conv import group_stats

# IO dtype -> the C entry point's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_C = 2048  # 16 bytes of channels a thread, at most 512 threads a row
# the kernel's constants (csrc/gn_swish_bwd.cu): threads a block, bytes of
# each tensor a thread has in flight, sets of group partials
GN_THREADS = 512
GN_PIPE_BYTES = 128
GN_PARTIAL_SETS = 4


def _bc(t):
    return t[:, None, None, :]


def gn_swish_ref(x, scale, bias, num_groups: int = 32, eps: float = 1e-6):
    """swish(GroupNorm(x) * scale + bias) in float32, rounded to x's dtype,
    and the statistics (mean_c, rstd_c), float32 (B, C)."""
    mean_c, rstd_c = group_stats(x, num_groups, eps)
    xhat = (x.float() - _bc(mean_c)) * _bc(rstd_c)
    hpre = xhat * scale.float() + bias.float()
    return (hpre * torch.sigmoid(hpre)).to(x.dtype), (mean_c, rstd_c)


def gn_swish_bwd_plain(x, dy, mean_c, rstd_c, gamma, beta, num_groups: int = 32):
    """Plain version of the backward kernel: (dx in x's dtype, dgamma,
    dbeta float32)."""
    b, h, w, c = x.shape
    cg = c // num_groups
    g32 = gamma.float()
    xhat = (x.float() - _bc(mean_c)) * _bc(rstd_c)
    hpre = xhat * g32 + beta.float()
    sig = torch.sigmoid(hpre)
    dh = dy.float() * (sig * (1.0 + hpre * (1.0 - sig)))
    s1 = (dh * xhat).sum(dim=(1, 2))  # (B, C)
    s2 = dh.sum(dim=(1, 2))
    inv_n = 1.0 / (h * w * cg)

    def group_mean(s):
        return ((s * g32).reshape(b, num_groups, cg).sum(-1) * inv_n).repeat_interleave(cg, dim=1)

    c1, c2 = group_mean(s2), group_mean(s1)
    dx = (dh * g32 - _bc(c1) - xhat * _bc(c2)) * _bc(rstd_c)
    return dx.to(x.dtype), s1.sum(dim=0), s2.sum(dim=0)


def gn_smem(c: int, groups: int, esize: int) -> int:
    """Shared memory of a block (``csrc/gn_swish_bwd.cu`` ``GnSmem``): each
    thread's ``GN_PIPE_BYTES`` of x and of dy in flight, the block
    reduction's rows of 2 * C sums (16 warps' where a warp holds whole rows,
    else every row slot's; a thread takes 16 bytes of a row), the block's 2
    * C sums, the sample's group constants, gamma and the ordered sum's
    scratch (a float a warp)."""
    tpr = c // (16 // esize)
    rows = GN_THREADS // 32 if tpr <= 32 and 32 % tpr == 0 else GN_THREADS // tpr
    return (GN_THREADS * 2 * GN_PIPE_BYTES + 4 * rows * 2 * c + 4 * 2 * c
            + 16 * -(-2 * groups // 4) + 4 * c + 4 * (GN_THREADS // 32))


@dataclasses.dataclass(frozen=True)
class GnBwdPlan:
    """The backward's launch (``gn_bwd_plan``), as ``csrc/gn_swish_bwd.cu``
    reads it (``as_array``, C ``GnPlan``): a sample's rows in ``cpu`` chunks
    of ``rows`` rows (the last may be short), a wave ``upw`` samples; block
    j of wave w takes chunk j % cpu of sample w * upw + j // cpu, so
    ``grid`` = upw * cpu blocks of ``threads`` threads, all resident,
    ``waves`` waves, ``smem`` bytes of shared memory a block."""

    grid: int
    threads: int
    rows: int
    cpu: int
    upw: int
    waves: int
    smem: int

    def as_array(self):
        """The plan as the C entry takes it: 7 int64 in ``GnPlan``'s order."""
        vals = [self.grid, self.threads, self.rows, self.cpu, self.upw, self.waves, self.smem]
        return (ctypes.c_longlong * len(vals))(*vals)

    def scratch_floats(self, b: int, c: int, groups: int) -> int:
        """float32 scratch of a call: the group partials of 4 waves' chunks,
        then every chunk's per-channel partials."""
        return GN_PARTIAL_SETS * self.grid * 2 * groups + b * self.cpu * 2 * c


def gn_bwd_plan(b: int, hw: int, c: int, groups: int, dtype,
                sms: int = grid_sync.SMS) -> GnBwdPlan:
    """The launch of the backward at x (b, hw, c), a function of the shape
    alone (so a result repeats): a wave of every sample where b <= ``sms``
    (else of ``sms`` samples), a sample's rows shared by ``sms // b`` blocks
    (at least one).  ``sms`` is the card's (an H100's by default)."""
    esize = torch.empty((), dtype=dtype).element_size()
    upw = min(b, sms)
    rows = -(-hw // (sms // upw))
    cpu = -(-hw // rows)
    return GnBwdPlan(upw * cpu, GN_THREADS, rows, cpu, upw, -(-b // upw),
                     gn_smem(c, groups, esize))


def gn_swish_bwd_cuda(x, dy, mean_c, rstd_c, gamma, beta, num_groups: int = 32):
    """Launch the backward kernel: x and dy (B, H, W, C) contiguous, 16-byte
    aligned CUDA tensors of one dtype (float32 or bf16), C a multiple of 8
    and of the groups, at most MAX_C -> (dx, dgamma, dbeta),
    bit-reproducible; one cooperative launch (``gn_bwd_plan``)."""
    _build.refuse_grad("GroupNorm + swish backward kernel", x, dy, gamma, beta)
    b, h, w, c = x.shape
    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"GroupNorm + swish backward kernel takes float32 or bf16 CUDA tensors, "
                         f"got {x.dtype} on {x.device}")
    if dy.shape != x.shape or dy.dtype != x.dtype or not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("GroupNorm + swish backward kernel: dy must match x, both contiguous")
    if c % 8 or c > MAX_C or c % num_groups:
        raise ValueError(f"GroupNorm + swish backward kernel: C={c} unsupported (a multiple of 8 "
                         f"and of {num_groups}, at most {MAX_C})")
    stats = [_build.kernel_operand(t.float()) for t in (mean_c, rstd_c, gamma, beta)]
    if stats[0].shape != (b, c) or stats[1].shape != (b, c) or stats[2].shape != (c,) \
            or stats[3].shape != (c,) or any(t.device != x.device for t in (dy, *stats)):
        raise ValueError("GroupNorm + swish backward kernel: mean_c, rstd_c (B, C) and gamma, "
                         "beta (C,) on x's device")
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("GroupNorm + swish backward kernel takes 16-byte aligned x and dy")
    plan = gn_bwd_plan(b, h * w, c, num_groups, x.dtype, grid_sync.device_sms(x.device))
    scratch = torch.empty((plan.scratch_floats(b, c, num_groups),), dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_gn_swish_bwd(x.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in stats),
                                   scratch.data_ptr(), dx.data_ptr(), dgb.data_ptr(),
                                   grid_sync.grid_counters(x.device).data_ptr(), b, h * w, c,
                                   num_groups, plan.as_array(), _DTYPE_CODES[x.dtype],
                                   _build.stream_of(x))
    _build.check(err, "gvq_gn_swish_bwd")
    gn_swish_bwd_cuda.launches += 1
    return dx, dgb[0], dgb[1]


gn_swish_bwd_cuda.launches = 0


class _GnSwishFn(torch.autograd.Function):
    """The plain forward, saving x and the statistics; the backward kernel
    (JAX ``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        y, (mean_c, rstd_c) = gn_swish_ref(x, scale, bias, num_groups, eps)
        ctx.save_for_backward(x, scale, bias, mean_c, rstd_c)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean_c, rstd_c = ctx.saved_tensors
        bwd = gn_swish_bwd_plain if x.device.type == "cpu" else gn_swish_bwd_cuda
        dx, dg, db = bwd(_build.kernel_operand(x), _build.kernel_operand(dy), mean_c, rstd_c,
                         scale, bias, ctx.num_groups)
        return dx, dg.to(scale.dtype), db.to(bias.dtype), None, None


def gn_swish(x, scale, bias, num_groups: int = 32, eps: float = 1e-6):
    """swish(GroupNorm(x) * scale + bias) of (B, H, W, C) x; when a gradient
    is wanted, its backward is the kernel (CUDA tensors) or its plain
    version (CPU tensors)."""
    if _build.wants_grad(x, scale, bias):
        return _GnSwishFn.apply(x, scale, bias, num_groups, eps)
    return gn_swish_ref(x, scale, bias, num_groups, eps)[0]
