"""What the labs share: the flash labs' shape, inputs and references, the
bound, the card check and the report of each combination."""

from __future__ import annotations

import os

import numpy as np
import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

# the JAX labs' shape: the bsqvit attention, bf16
B, L, H, D = 16, 1024, 12, FL.HEAD_DIM
SCALE = D ** -0.5
ATOL = 2e-2  # the JAX package's bf16 attention bar (max error against the reference)
# published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_HBM = 3.35e12  # bytes/s


def fwd_flops_bytes(b: int = B, l: int = L, h: int = H, d: int = D):
    """(FLOP, bytes) of one forward launch: q k^T and P V; q, k, v in, o out."""
    return 4.0 * b * h * l * l * d, 4 * 2 * b * l * h * d


def bwd_flops_bytes(products: int, b: int = B, l: int = L, h: int = H, d: int = D):
    """(FLOP, bytes) of one backward launch of `products` L x L x D products:
    q, k, v, o, do in (bf16), z in (float32), dq, dk, dv out."""
    return 2.0 * products * b * h * l * l * d, 8 * 2 * b * l * h * d + 4 * b * h * l


def bound_ms(flops: float, nbytes: float):
    """(least ms for the work at the bf16 and memory peaks, which bound)."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_shape(t, heads: int = H):
    """A (B, L, H*D) tensor as SDPA's head-major (B, H, L, D), contiguous."""
    b, l, c = t.shape
    return t.reshape(b, l, heads, c // heads).permute(0, 2, 1, 3).contiguous()


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the labs run on a CUDA card; on the CPU use the plain versions "
                           "of ops/flash_lab.py and ops/ln_matmul.py")


def lab_inputs(n: int, seed: int = 0, b: int = B, l: int = L, h: int = H, device="cuda"):
    """n (b, l, h * 64) bf16 tensors drawn as the JAX labs draw them:
    ``default_rng(seed).standard_normal`` one after the other."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, l, h * D))).to(device, torch.bfloat16)
            for _ in range(n)]


def einsum_reference(q, k, v, heads: int = H):
    """softmax(q k^T scale) v in float32, (B, L, H*D): the JAX labs'
    ``max_err`` reference."""
    qh, kh, vh = (sdpa_shape(t, heads).float() for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * SCALE, dim=-1)
    o = p @ vh
    return o.permute(0, 2, 1, 3).reshape(q.shape)


def einsum_grads(q, k, v, do, heads: int = H):
    """(dq, dk, dv) of ``einsum_reference`` in float32, by autograd."""
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o = einsum_reference(*leaves, heads=heads)
    return torch.autograd.grad(o, leaves, do.float())


def sdpa_fwd_ms(q, k, v, heads: int = H) -> float:
    """One ``scaled_dot_product_attention`` forward on head-major copies
    (made beforehand) of the same tensors: a yardstick only."""
    import torch.nn.functional as F

    from vqvae_from_gaussian_vae_tpu_torch.labs._timing import time_ms

    qh, kh, vh = (sdpa_shape(t, heads) for t in (q, k, v))
    return time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=SCALE))


def sdpa_bwd_ms(q, k, v, do, heads: int = H) -> float:
    """SDPA's backward alone (autograd, the forward run once outside), on
    head-major copies of the same tensors: a yardstick only."""
    import torch.nn.functional as F

    from vqvae_from_gaussian_vae_tpu_torch.labs._timing import time_ms

    leaves = [sdpa_shape(t, heads).requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, scale=SCALE)
    doh = sdpa_shape(do, heads)
    return time_ms(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True))


def ptxas_usage() -> dict:
    """ptxas's report of the built library (``nvcc.log``), by kernel."""
    path = os.path.join(_build.build_dir(), "nvcc.log")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return _build.ptxas_usage(f.read())


def kernel_facts(report: dict) -> str:
    """The blocks, registers and spill bytes of a lab report, for its line."""
    def one(u):
        spills = u.get("spill_stores", 0) + u.get("spill_loads", 0) if u else "?"
        return f"{u.get('registers', '?')} regs, {spills} B spills"
    px = report.get("ptxas") or {}
    regs = ("; ".join(f"{k} {one(u)}" for k, u in px.items()) if "dkdv" in px else one(px))
    return f"blocks {report.get('blocks')}  {regs}"


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_max(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())
