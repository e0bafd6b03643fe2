"""Head-major flash attention on (B, H, L, D) tensors, with its backward.

Replaces the TPU kernels of ``vqvae_from_gaussian_vae_tpu/ops/flash_attention.py``:
the forward (``flash_attention`` and the VJP's ``_fwd``, both the upstream
Pallas ``_flash_attention_impl``; the training form also keeps the row
statistics) and the backward ``_bwd``: the dk/dv pass (upstream
``_flash_attention_bwd_dkv``) from di = rowsum(o * do) in float32, then
``_bwd_dq_lean`` (the dq pass).  The op: o = softmax(q k^T * sm_scale) v per
(batch, head), unmasked and non-causal, with no segment ids and no bias; q
is (B, H, Lq, D), k and v (B, H, Lk, D), and Lq need not equal Lk.

Numerics, in the kernels and in the plain versions here: float32 scores; p
rounded to the IO dtype before the P.V product (float32 accumulation); the
row sum over the float32 p and the normaliser applied at the end.  The
training forward keeps z = m + ln l (the row maximum and the row sum of the
scaled scores) where the JAX op keeps l and m: the function is o and its
gradients.  The backward rebuilds p = exp(s - z); ds = p (do v^T - di)
scale rounded to the IO dtype; dq = ds k, dk = ds^T q, dv = round(p)^T do,
each accumulated in float32.

``BlockSizes`` is a copy of the upstream dataclass, and ``flash_attention``
raises ``ValueError`` where the JAX op raises: a block larger than its
dimension, a block that does not divide its sequence length (``block_q`` of
the forward excepted: its last q block may be partial), and a backward
without the backward blocks.  The block sizes are checked for that contract
only: they do not set the Hopper kernels' tiling (bf16 forward: 192 q rows
at D = 64 and 128 at D = 128 against 128-key tiles, 32 q rows against
64-key tiles at D = 256 and 512; bf16 backward: 128-key and 128-q-row
blocks against 64- or 32-row q tiles and 128- or 64-key tiles at D = 64
and 128, 64-key and 64-q-row blocks of 256 columns against 32-row tiles at
D = 256 and 512; float32: ``flash_f32_plan``'s
tiles, at D = 256 and 512 64 rows of a share of D's columns a block against
8- to 16-row tiles).  So where the JAX op fails inside its TPU kernel bodies
rather than in a check (a k block that is not a multiple of the 128 lanes:
TypeError or NotImplementedError while tracing), the port computes.

``flash_attention`` is a ``torch.autograd.Function`` when a gradient is
wanted.  The CUDA kernels run for CUDA tensors, bf16 or float32 as the JAX
op does, D in ``SUPPORTED_HEAD_DIMS`` (the token-major kernels' head dims),
any Lq, Lk >= 1; ``flash_attention`` copies an operand that is not
contiguous or whose data lies off 16 bytes into a fresh buffer first
(``_build.kernel_operand``), where the ``*_cuda`` wrappers raise on data
off 16 bytes.  The kernels are chosen by dtype: bf16 ``csrc/flash_fwd.cu``
entry ``gvq_flash_fwd_hm`` and ``csrc/flash_bwd.cu`` entry
``gvq_flash_bwd_hm`` (tensor cores; their launches from
``ops/flash_attention.py``'s ``flash_fwd_plan`` and ``flash_bwd_plan``);
float32 ``gvq_flash_fwd_hm_f32`` and ``gvq_flash_bwd_hm_f32``, launched
from ``flash_f32_plan``: split TF32 on the tensor cores (each product
three TF32 ``wgmma`` passes over (hi, lo) pairs that a pre-pass writes into
a scratch buffer, float32-accurate, so
``torch.backends.cuda.matmul.allow_tf32`` is not read: on or off, the
result is the same), at D = 256 and 512 with a block a share of D's columns
and a cluster of blocks a row tile.  Any other dtype or head dim raises.  The plain versions below run for CPU tensors, in
any float dtype, and are what the kernels are held to on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import (
    SUPPORTED_HEAD_DIMS, check_aligned, flash_bwd_plan, flash_f32_plan, flash_fwd_plan)


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes of the JAX op (the upstream Pallas module's dataclass, with
    its checks).  Here they are a contract on the shapes, not a tiling."""

    block_q: int
    block_k_major: int
    block_k: int
    block_b: int

    block_q_major_dkv: Optional[int] = None
    block_k_major_dkv: Optional[int] = None
    block_k_dkv: Optional[int] = None
    block_q_dkv: Optional[int] = None

    block_k_major_dq: Optional[int] = None
    block_k_dq: Optional[int] = None
    block_q_dq: Optional[int] = None

    def __post_init__(self):
        def verify_major_minor(prefix, suffix, major, minor):
            if minor > major:
                raise ValueError(f"{prefix}{suffix}={minor} should be smaller than"
                                 f" {prefix}_major{suffix}={major}")
            if major % minor != 0:
                raise ValueError(f"{prefix}{suffix}={minor} should divide"
                                 f" {prefix}_major{suffix}={major}")

        verify_major_minor("block_k", "", self.block_k_major, self.block_k)
        if self.block_q_major_dkv is not None and self.block_q_dkv is not None:
            verify_major_minor("block_q", "_dkv", self.block_q_major_dkv, self.block_q_dkv)
        if self.block_k_major_dkv is not None and self.block_k_dkv is not None:
            verify_major_minor("block_k", "_dkv", self.block_k_major_dkv, self.block_k_dkv)
        if self.block_k_major_dq is not None and self.block_k_dq is not None:
            verify_major_minor("block_k", "_dq", self.block_k_major_dq, self.block_k_dq)

    @property
    def has_backward_blocks(self) -> bool:
        return all(b is not None for b in (
            self.block_q_major_dkv, self.block_k_major_dkv, self.block_q_dkv,
            self.block_k_dkv, self.block_k_major_dq, self.block_k_dq, self.block_q_dq))

    @classmethod
    def get_default(cls, batch_size, num_heads, q_seq_len, kv_len, d_model):
        del batch_size, num_heads, q_seq_len, kv_len, d_model  # as upstream: one default
        return BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1,
                          block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
                          block_q_dkv=128, block_k_major_dq=128, block_k_dq=128,
                          block_q_dq=128)


def _verify_block(block_name, dim_name, block, dim, should_divide=True):
    if block > dim:
        raise ValueError(f"{block_name}={block} should be smaller or equal to {dim_name}={dim}")
    if should_divide and dim % block != 0:
        raise ValueError(f"{dim_name}={dim} should be divisible by {block_name}={block}")


def _check_shapes(q, k, v):
    """Raise unless q (B, H, Lq, D) and k, v (B, H, Lk, D) share one dtype
    and device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"head-major flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (want (B, H, Lq, D) and two (B, H, Lk, D))")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("head-major flash attention: q, k, v must share a dtype and a device")


def _check_forward_blocks(q, k, block_sizes: BlockSizes) -> None:
    """The forward's checks (upstream ``_flash_attention_impl``)."""
    batch, _, lq, _ = q.shape
    lk = k.shape[2]
    _verify_block("block_q", "q_seq_len", block_sizes.block_q, lq, should_divide=False)
    _verify_block("block_k_major", "kv_seq_len", block_sizes.block_k_major, lk)
    _verify_block("block_k", "kv_seq_len", block_sizes.block_k, lk)
    _verify_block("block_b", "batch", block_sizes.block_b, batch, should_divide=False)


def _check_backward_blocks(q, k, block_sizes: BlockSizes) -> None:
    """The backward's checks: the JAX op's ``_bwd``, the upstream dk/dv
    pass's, and ``_bwd_dq_lean``'s."""
    if not block_sizes.has_backward_blocks:
        raise ValueError("Program is being differentiated, but not all backward blocks "
                         "are specified in BlockSizes")
    lq, lk = q.shape[2], k.shape[2]
    bs = block_sizes
    _verify_block("block_q_major_dkv", "q_seq_len", bs.block_q_major_dkv, lq)
    _verify_block("block_q_dkv", "q_seq_len", bs.block_q_dkv, lq)
    _verify_block("block_k_major_dkv", "kv_seq_len", bs.block_k_major_dkv, lk)
    _verify_block("block_k_dkv", "kv_seq_len", bs.block_k_dkv, lk)
    _verify_block("block_q_dq", "q_seq_len", bs.block_q_dq, lq)
    _verify_block("block_k_major_dq", "kv_seq_len", bs.block_k_major_dq, lk)
    _verify_block("block_k_dq", "block_k", bs.block_k_dq, lk)


def flash_attention_res_plain(q, k, v, sm_scale: float):
    """Plain version of the forward: (o, z), o (B, H, Lq, D) in v's dtype,
    z (B, H, Lq) float32, z = m + ln(sum) of each row's scaled scores."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    row_sum = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    o = o * (1.0 / row_sum)[..., None]
    return o.to(v.dtype), m + torch.log(row_sum)


def flash_attention_bwd_plain(q, k, v, o, z, do, sm_scale: float):
    """Plain version of the backward kernels: (dq, dk, dv) in q's dtype from
    the forward's q, k, v, o, z and the cotangent do of o."""
    io = q.dtype
    qf, kf, dof = q.float(), k.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - z[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    di = (dof * o.float()).sum(dim=-1)
    ds = (p * (dp - di[..., None]) * sm_scale).to(io).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(io).float(), dof)
    return dq.to(io), dk.to(io), dv.to(io)


# the kernels' C entry points (forward, backward) by dtype
_ENTRIES = {torch.bfloat16: ("gvq_flash_fwd_hm", "gvq_flash_bwd_hm"),
            torch.float32: ("gvq_flash_fwd_hm_f32", "gvq_flash_bwd_hm_f32")}


def _scratch(floats: int, device):
    """A fresh float32 buffer of `floats` for the split-TF32 pre-pass.
    Freed after the launch, it goes back to the caching allocator, which
    hands it out again only to work queued after the kernels on the same
    stream."""
    return torch.empty((floats,), dtype=torch.float32, device=device)


def _check_cuda(name: str, *tensors) -> None:
    """Raise on what the head-major kernels do not take."""
    q = tensors[0]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in _ENTRIES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name} takes bf16 or float32 tensors of one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: D={q.shape[-1]} unsupported (D in {SUPPORTED_HEAD_DIMS})")


def flash_attention_fwd_cuda(q, k, v, sm_scale: float, save_residuals: bool = False):
    """Launch the forward kernel on bf16 or float32 CUDA tensors: o, or (o,
    z) with ``save_residuals`` (the training form)."""
    _build.refuse_grad("head-major flash kernel (outside its autograd Function)", q, k, v)
    _check_shapes(q, k, v)
    _check_cuda("head-major flash kernel", q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_aligned("head-major flash kernel", q, k, v)
    o = torch.empty_like(q)
    z = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if save_residuals else None
    entry = _ENTRIES[q.dtype][0]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if z is None else z.data_ptr()]
    if q.dtype == torch.bfloat16:
        plan = flash_fwd_plan("head_major", b, h, lq, lk, d).as_array()
    else:  # the float32 entry also takes the pre-pass's scratch
        f32 = flash_f32_plan(b, h, lq, lk, d)
        plan, scratch = f32.as_array(), _scratch(f32.fwd_scratch, q.device)
        ptrs.append(scratch.data_ptr())
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), entry)(*ptrs, b, h, lq, lk, d, float(sm_scale), plan,
                                               _build.stream_of(q))
    _build.check(err, entry)
    flash_attention_fwd_cuda.launches += 1
    return (o, z) if save_residuals else o


flash_attention_fwd_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, z, do, sm_scale: float):
    """Launch the backward kernels (di pre-pass, dk/dv, dq): (dq, dk, dv) in
    q's dtype (bf16 or float32), from contiguous q, o, do (B, H, Lq, D), k,
    v (B, H, Lk, D) of that dtype and z (B, H, Lq) float32."""
    _build.refuse_grad("head-major flash backward kernel", q, k, v, o, z, do)
    _check_shapes(q, k, v)
    _check_cuda("head-major flash backward kernel", q, k, v, o, do)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t, shape, dtype in (("q", q, q.shape, q.dtype), ("k", k, k.shape, q.dtype),
                                  ("v", v, k.shape, q.dtype), ("o", o, q.shape, q.dtype),
                                  ("do", do, q.shape, q.dtype),
                                  ("z", z, (b, h, lq), torch.float32)):
        if t.device != q.device or tuple(t.shape) != tuple(shape) or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"head-major flash backward kernel: {name} must be a contiguous "
                             f"{tuple(shape)} {dtype} tensor on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    check_aligned("head-major flash backward kernel", q, k, v, o, z, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    entry = _ENTRIES[q.dtype][1]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), z.data_ptr(), do.data_ptr(),
            di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    if q.dtype == torch.bfloat16:
        plan = flash_bwd_plan("head_major", b, h, lq, lk, d).as_array()
    else:  # the float32 entry also takes the pre-pass's scratch
        f32 = flash_f32_plan(b, h, lq, lk, d)
        plan, scratch = f32.as_array(), _scratch(f32.bwd_scratch, q.device)
        ptrs.append(scratch.data_ptr())
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), entry)(*ptrs, b, h, lq, lk, d, float(sm_scale), plan,
                                               _build.stream_of(q))
    _build.check(err, entry)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class _FlashLeanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, block_sizes):
        if q.device.type == "cpu":
            o, z = flash_attention_res_plain(q, k, v, sm_scale)
        else:
            q, k, v = (_build.kernel_operand(t) for t in (q, k, v))
            o, z = flash_attention_fwd_cuda(q, k, v, sm_scale, save_residuals=True)
        ctx.save_for_backward(q, k, v, o, z)
        ctx.sm_scale, ctx.block_sizes = sm_scale, block_sizes
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, z = ctx.saved_tensors
        _check_backward_blocks(q, k, ctx.block_sizes)
        do = _build.kernel_operand(do)
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd_cuda
        return (*bwd(q, k, v, o, z, do, ctx.sm_scale), None, None)


def flash_attention(q, k, v, sm_scale: float, block_sizes: BlockSizes):
    """o = softmax(q k^T * sm_scale) v, q (B, H, Lq, D), k and v (B, H, Lk,
    D): the kernels for CUDA tensors, the plain versions for CPU tensors.
    When a gradient is wanted, the training forward and the backward run
    through an autograd Function, and the backward checks the backward
    blocks."""
    _check_shapes(q, k, v)
    _check_forward_blocks(q, k, block_sizes)
    if _build.wants_grad(q, k, v):
        return _FlashLeanFn.apply(q, k, v, sm_scale, block_sizes)
    if q.device.type == "cpu":
        return flash_attention_res_plain(q, k, v, sm_scale)[0]
    return flash_attention_fwd_cuda(*(_build.kernel_operand(t) for t in (q, k, v)), sm_scale)
