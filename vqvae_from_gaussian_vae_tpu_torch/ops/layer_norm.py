"""Row LayerNorm, and the fused residual add + LayerNorm, with their backward.

Replaces the TPU kernels of ``vqvae_from_gaussian_vae_tpu/ops/layer_norm.py``:
``_ln_fwd_2d`` / ``_ln_fwd_kernel``, ``_ln_add_fwd_2d`` /
``_ln_add_fwd_kernel``, ``_ln_bwd_2d`` / ``_ln_bwd_kernel`` and
``_ln_add_bwd_2d`` / ``_ln_add_bwd_kernel``, behind ``layer_norm`` and
``layer_norm_add``.  Over the last axis, with float32 statistics, the
variance as the mean of ``(x - mean)^2``, and the output in the input's
dtype:

    layer_norm(x, w, b)         -> LN(x)
    layer_norm_add(x, d, w, b)  -> (s, LN(s)),  s = x + d rounded to x's dtype

The add variant takes its statistics from the rounded ``s``, as the TPU
kernel does.  Both are ``torch.autograd.Function``s when a gradient is
wanted: the forward saves only its input (``x``, or the add variant's
``s``), and the backward recomputes the row statistics from it; the add
variant's backward adds the cotangent of ``s`` to dx and returns dx for both
``x`` and ``d``.  dweight and dbias are float32 sums over all rows.

The CUDA kernels (``csrc/layer_norm.cu``; each backward one cooperative
launch that streams row slabs through shared memory and sums dweight and
dbias inside it, ``ln_bwd_plan`` sizing it) run for CUDA tensors; the plain
versions below run for CPU tensors and are what the kernels are held to on
the card.  The public ops take any layout: an operand that is strided or
whose data lies off 16 bytes is copied once into a fresh buffer
(``_build.kernel_operand``), where the ``*_cuda`` wrappers raise on it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build, grid_sync

# IO dtype -> the C entry points' dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_C = 4096  # a row of at most 128 floats in each lane's registers
# the backward's constants (csrc/layer_norm.cu): the most stages of its
# ring, the bytes a slab aims at where a row a warp does not fit, and the
# 16-byte chunks of a row a lane may hold (the kernels' NCH classes, as the
# forward's dispatch)
LN_BWD_MAX_STAGES = 4
LN_BWD_SLAB_BYTES = 40960
NCH_CLASSES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """Plain version of the LN kernel."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)


def layer_norm_add_plain(x, delta, weight, bias, eps: float = 1e-5):
    """Plain version of the LN-add kernel: (s, LN(s))."""
    s = (x.float() + delta.float()).to(x.dtype)
    return s, layer_norm_plain(s, weight, bias, eps)


def layer_norm_bwd_plain(x, weight, dy, eps: float = 1e-5, ds_in=None):
    """Plain version of the LN backward kernels: (dx, dweight, dbias).

    The row statistics are recomputed from x; with ``ds_in`` (the add
    variant, x being its saved s) the cotangent of s is added to dx before
    rounding.  dweight and dbias are float32."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    dyf = dy.float().reshape(-1, c)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    wdy = dyf * weight.float()
    c1 = wdy.mean(dim=-1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd
    if ds_in is not None:
        dx = dx + ds_in.float().reshape(-1, c)
    return (dx.to(x.dtype).reshape(x.shape), (dyf * xhat).sum(dim=0), dyf.sum(dim=0))


def _check(name: str, x, others, weight, bias) -> int:
    """Raise on what the kernel does not take; return the row width C."""
    c = x.shape[-1] if x.dim() else 0
    if not (x.is_cuda and all(t.device == x.device for t in (*others, weight, bias))):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in others):
        raise ValueError(f"{name} takes float32 or bf16 rows of one dtype, got "
                         f"{[x.dtype] + [t.dtype for t in others]}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 weight and bias")
    if c % 8 or not 8 <= c <= MAX_C:
        raise ValueError(f"{name}: C={c} unsupported (a multiple of 8, at most {MAX_C})")
    if any(t.shape != x.shape for t in others) or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in (x, *others, weight, bias)]}")
    for t in (x, *others, weight, bias):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    return c


def layer_norm_cuda(x, weight, bias, eps: float = 1e-5):
    """Launch the LN kernel: (..., C) float32 or bf16 CUDA rows, float32
    weight and bias, C a multiple of 8 up to MAX_C."""
    _build.refuse_grad("layer_norm kernel (outside its autograd Function)", x, weight, bias)
    c = _check("layer_norm kernel", x, (), weight, bias)
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_layer_norm_fwd(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                     y.data_ptr(), rows, c, _DTYPE_CODES[x.dtype], float(eps),
                                     _build.stream_of(x))
    _build.check(err, "gvq_layer_norm_fwd")
    layer_norm_cuda.launches += 1
    return y


layer_norm_cuda.launches = 0


def layer_norm_add_cuda(x, delta, weight, bias, eps: float = 1e-5):
    """Launch the LN-add kernel: (s, LN(s)) with s = x + delta in x's dtype."""
    _build.refuse_grad("layer_norm_add kernel (outside its autograd Function)", x, delta,
                       weight, bias)
    c = _check("layer_norm_add kernel", x, (delta,), weight, bias)
    s, y = torch.empty_like(x), torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return s, y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gvq_layer_norm_add_fwd(x.data_ptr(), delta.data_ptr(), weight.data_ptr(),
                                         bias.data_ptr(), s.data_ptr(), y.data_ptr(), rows, c,
                                         _DTYPE_CODES[x.dtype], float(eps), _build.stream_of(x))
    _build.check(err, "gvq_layer_norm_add_fwd")
    layer_norm_add_cuda.launches += 1
    return s, y


layer_norm_add_cuda.launches = 0


def nch_class(c: int, dtype) -> int:
    """16-byte chunks of a row a lane holds in the kernel that takes width c:
    the smallest class that covers c (``dispatch_bwd``)."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    need = -(-(c // v) // 32)
    return next(n for n in NCH_CLASSES if n * v <= MAX_C // 32 and need <= n)


def ln_bwd_threads(c: int, dtype) -> int:
    """Threads of the backward block at width c (``BwdThreads``): 16 warps
    where a lane's share of a row leaves each thread 128 registers, else 8."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    return 512 if nch_class(c, dtype) * v <= 64 else 256


def ln_bwd_smem(c: int, esize: int, add: bool, rows: int, stages: int) -> int:
    """Shared memory of a backward block (``csrc/layer_norm.cu``
    ``LnBwdSmem``): the stages of `rows` rows of x, dy (and ds_in), each
    row's (mean, rstd), gamma, the ordered sum's scratch and the
    mbarriers."""
    stage = -(-rows * c * esize * (3 if add else 2) // 128) * 128
    return stages * stage + 16 * -(-rows * 8 // 16) + 4 * c + 64 + 8 * stages


@dataclasses.dataclass(frozen=True)
class LnBwdPlan:
    """The backward's launch (``ln_bwd_plan``), as ``csrc/layer_norm.cu``
    reads it (``as_array``, C ``LnBwdPlan``): ``grid`` blocks of ``threads``
    threads, one an SM, all resident, block j owning rows [R j / grid, R (j
    + 1) / grid) and streaming them in slabs of ``rows`` rows through a ring
    of ``stages`` stages; ``smem`` bytes of shared memory a block."""

    grid: int
    threads: int
    rows: int
    stages: int
    smem: int

    def as_array(self):
        """The plan as the C entries take it: 5 int64 in ``LnBwdPlan``'s order."""
        vals = [self.grid, self.threads, self.rows, self.stages, self.smem]
        return (ctypes.c_longlong * len(vals))(*vals)


def ln_bwd_plan(rows: int, c: int, dtype, add: bool = True, sms: int = grid_sync.SMS,
                smem_max: int = grid_sync.SMEM_BLOCK_MAX) -> LnBwdPlan:
    """The launch of the LN backward (``add``: the LN-add backward, whose
    slabs carry ds_in too) on (rows, c) rows, a function of the shape alone:
    a slab of a row for each warp where three stages of it fit, else of 8
    rows where three of those fit, else of about ``LN_BWD_SLAB_BYTES``; the
    ring as deep as shared memory allows, up to four stages; one block an
    SM, and at most one block a slab of rows."""
    esize = torch.empty((), dtype=dtype).element_size()
    threads = ln_bwd_threads(c, dtype)
    row_bytes = c * esize * (3 if add else 2)
    slab = next((n for n in (threads // 32, 8)
                 if ln_bwd_smem(c, esize, add, n, 3) <= smem_max),
                max(1, min(64, LN_BWD_SLAB_BYTES // row_bytes)))
    stages = LN_BWD_MAX_STAGES
    while stages > 2 and ln_bwd_smem(c, esize, add, slab, stages) > smem_max:
        stages -= 1
    return LnBwdPlan(max(1, min(sms, -(-rows // slab))), threads, slab, stages,
                     ln_bwd_smem(c, esize, add, slab, stages))


def _bwd_cuda(name, x, weight, dy, ds_in, eps):
    others = (dy,) if ds_in is None else (dy, ds_in)
    _build.refuse_grad(name, x, weight, *others)  # no double backward
    c = _check(name, x, others, weight, weight)
    rows = x.numel() // c
    dx = torch.empty_like(x)
    if rows == 0:
        dgb = torch.zeros((2, c), dtype=torch.float32, device=x.device)
        return dx, dgb[0], dgb[1]
    plan = ln_bwd_plan(rows, c, x.dtype, add=ds_in is not None)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((plan.grid, 2, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    code, stream = _DTYPE_CODES[x.dtype], _build.stream_of(x)
    with torch.cuda.device(x.device):
        counters = grid_sync.grid_counters(x.device).data_ptr()
        if ds_in is None:
            err = lib.gvq_layer_norm_bwd(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                                         dx.data_ptr(), part.data_ptr(), dgb.data_ptr(), counters,
                                         rows, c, plan.as_array(), code, float(eps), stream)
        else:
            err = lib.gvq_layer_norm_add_bwd(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                                             ds_in.data_ptr(), dx.data_ptr(), part.data_ptr(),
                                             dgb.data_ptr(), counters, rows, c, plan.as_array(),
                                             code, float(eps), stream)
    _build.check(err, "gvq_layer_norm_bwd" if ds_in is None else "gvq_layer_norm_add_bwd")
    return dx, dgb[0], dgb[1]


def layer_norm_bwd_cuda(x, weight, dy, eps: float = 1e-5):
    """Launch the LN backward kernel: (dx, dweight, dbias) from the
    forward's input x and the cotangent dy (both (..., C), one dtype); one
    cooperative launch (``ln_bwd_plan``)."""
    out = _bwd_cuda("layer_norm backward kernel", x, weight, dy, None, eps)
    layer_norm_bwd_cuda.launches += 1
    return out


layer_norm_bwd_cuda.launches = 0


def layer_norm_add_bwd_cuda(s, weight, dy, ds_in, eps: float = 1e-5):
    """Launch the LN-add backward kernel: (dx, dweight, dbias) from the
    forward's rounded sum s and the cotangents dy (of y) and ds_in (of s);
    one cooperative launch (``ln_bwd_plan``)."""
    out = _bwd_cuda("layer_norm_add backward kernel", s, weight, dy, ds_in, eps)
    layer_norm_add_bwd_cuda.launches += 1
    return out


layer_norm_add_bwd_cuda.launches = 0


def _on_cpu(x) -> bool:
    return x.device.type == "cpu"


def _operands(*tensors) -> tuple:
    """Each tensor as the kernels read it: itself, or one fresh contiguous
    copy where it is strided or its data lies off 16 bytes."""
    return tuple(_build.kernel_operand(t) for t in tensors)


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        if not _on_cpu(x):
            x, weight, bias = _operands(x, weight, bias)
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if _on_cpu(x):
            return layer_norm_plain(x, weight, bias, eps)
        return layer_norm_cuda(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = _build.kernel_operand(dy)
        if _on_cpu(x):
            dx, dw, db = layer_norm_bwd_plain(x, weight, dy, ctx.eps)
        else:
            dx, dw, db = layer_norm_bwd_cuda(x, weight, dy, ctx.eps)
        return dx, dw, db, None


class _LayerNormAddFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, weight, bias, eps):
        ctx.set_materialize_grads(True)  # an unused s gives a zero ds_in
        if _on_cpu(x):
            s, y = layer_norm_add_plain(x, delta, weight, bias, eps)
        else:
            s, y = layer_norm_add_cuda(*_operands(x, delta, weight, bias), eps)
        ctx.save_for_backward(s, weight)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, ds_in, dy):
        s, weight = ctx.saved_tensors
        dy, ds_in = _operands(dy, ds_in)
        if _on_cpu(s):
            dx, dw, db = layer_norm_bwd_plain(s, weight, dy, ctx.eps, ds_in=ds_in)
        else:
            dx, dw, db = layer_norm_add_bwd_cuda(s, weight, dy, ds_in, ctx.eps)
        return dx, dx, dw, db, None


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LN over the last axis: the kernel for CUDA tensors, the plain version
    for CPU tensors; differentiable (backward kernel) when a gradient is
    wanted."""
    if _build.wants_grad(x, weight, bias):
        return _LayerNormFn.apply(x, weight, bias, eps)
    if _on_cpu(x):
        return layer_norm_plain(x, weight, bias, eps)
    return layer_norm_cuda(*_operands(x, weight, bias), eps)


def layer_norm_add(x, delta, weight, bias, eps: float = 1e-5):
    """(s, LN(s)) with s = x + delta: the kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable when a gradient is wanted."""
    if _build.wants_grad(x, delta, weight, bias):
        return _LayerNormAddFn.apply(x, delta, weight, bias, eps)
    if _on_cpu(x):
        return layer_norm_add_plain(x, delta, weight, bias, eps)
    return layer_norm_add_cuda(*_operands(x, delta, weight, bias), eps)
