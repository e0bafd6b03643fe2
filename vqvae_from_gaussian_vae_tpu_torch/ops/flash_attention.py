"""Flash-attention forward on token-major (B, L, H*D) tensors.

Replaces the TPU kernel ``vqvae_from_gaussian_vae_tpu/ops/flash_blc.py``
(``_fwd_impl``, called through ``flash_attention_blc`` and the front door
``sdpa_token_major``), forward only.  Per head: softmax(q k^T * scale) v
with float32 scores, p rounded to v's dtype before the P.V product
(float32 accumulation), the row sum over the float32 p, and the normaliser
applied at the end.  The CUDA kernel (``csrc/flash_fwd.cu``) runs for CUDA
tensors; the plain version below runs for CPU tensors and is what the
kernel is held to on the card.
"""

from __future__ import annotations

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (64, 128, 256, 512)


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


def flash_attention_cuda(q, k, v, sm_scale: float, num_heads: int):
    """Launch the kernel: bf16 CUDA tensors, L a multiple of 64, head dim in
    SUPPORTED_HEAD_DIMS."""
    b, l, c = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel takes CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash kernel takes bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or c % num_heads:
        raise ValueError(f"flash kernel: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} with {num_heads} heads")
    d = c // num_heads
    if d not in SUPPORTED_HEAD_DIMS or l % 64:
        raise ValueError(f"flash kernel: L={l}, D={d} unsupported (L % 64 == 0, "
                         f"D in {SUPPORTED_HEAD_DIMS})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.gvq_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                b, l, num_heads, d, float(sm_scale), _build.stream_of(q))
    _build.check(err, "gvq_flash_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, sm_scale: float, num_heads: int):
    """(B, L, H*D) x3 -> (B, L, H*D): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, num_heads)
    return flash_attention_cuda(q, k, v, sm_scale, num_heads)


def sdpa_token_major(q, k, v, sm_scale: float = None):
    """softmax(q k^T * sm_scale) v over token-major (B, L, H, D) inputs,
    returning (B, L, H*D).

    bf16 values go through ``flash_attention`` (the kernel on the card);
    float32 keeps the exact einsum path with a float32 softmax, as the JAX
    package does for its float32 parity path.
    """
    b, l, h, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if v.dtype == torch.bfloat16:
        return flash_attention(q.to(v.dtype).reshape(b, l, h * d),
                               k.to(v.dtype).reshape(b, l, h * d),
                               v.reshape(b, l, h * d), sm_scale, h)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(b, l, h * d)
