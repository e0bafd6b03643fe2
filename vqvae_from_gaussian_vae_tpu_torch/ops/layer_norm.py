"""Row LayerNorm forward, and the fused residual add + LayerNorm.

Replaces the TPU kernels of ``vqvae_from_gaussian_vae_tpu/ops/layer_norm.py``
(``_ln_fwd_2d`` / ``_ln_fwd_kernel`` and ``_ln_add_fwd_2d`` /
``_ln_add_fwd_kernel``, behind ``layer_norm`` and ``layer_norm_add``),
forward only.  Over the last axis, with float32 statistics, the variance as
the mean of ``(x - mean)^2``, and the output in the input's dtype:

    layer_norm(x, w, b)         -> LN(x)
    layer_norm_add(x, d, w, b)  -> (s, LN(s)),  s = x + d rounded to x's dtype

The add variant takes its statistics from the rounded ``s``, as the TPU
kernel does.  The CUDA kernels (``csrc/layer_norm.cu``) run for CUDA
tensors; the plain versions below run for CPU tensors and are what the
kernels are held to on the card.
"""

from __future__ import annotations

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

# IO dtype -> the C entry points' dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_C = 4096  # a row of at most 128 floats in each lane's registers


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


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LN over the last axis: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    return layer_norm_cuda(x, weight, bias, eps)


def layer_norm_add(x, delta, weight, bias, eps: float = 1e-5):
    """(s, LN(s)) with s = x + delta: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_add_plain(x, delta, weight, bias, eps)
    return layer_norm_add_cuda(x, delta, weight, bias, eps)
