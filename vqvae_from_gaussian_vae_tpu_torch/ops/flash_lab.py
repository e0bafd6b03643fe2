"""The flash labs' kernels: the bf16 flash bodies at settings no model runs.

Replaces three TPU kernels, all microbenchmarks of the JAX package's
``scripts/`` that no model calls:

* ``scripts/exp_flash_variants.py:54 make_kernel`` (B15): the forward under
  a softmax policy and a pipeline depth -> ``flash_variant_cuda``;
* ``scripts/exp_flash_fwd_tilings.py:32 run`` (B16): the shipped forward at
  explicit tilings -> ``flash_fwd_tiling_cuda``;
* ``scripts/exp_flash_bwd_variants.py:103 run`` and ``:49 _control_kernel``
  (B17): the shipped backward at explicit tilings -> ``flash_bwd_tiling_cuda``,
  and its no-softmax control -> ``flash_bwd_control_cuda``.

The kernels are ``csrc/flash_lab_fwd.cu`` (``gvq_flash_lab_fwd``) and
``csrc/flash_lab_bwd.cu`` (``gvq_flash_lab_bwd``): the bodies of
``csrc/flash_fwd.cuh`` and ``csrc/flash_bwd.cuh`` instantiated at the
combinations listed here, and only those.  A combination that is not
compiled raises ``ValueError`` naming the compiled ones; nothing is put in
its place.  Every wrapper takes bf16 CUDA tensors in the token-major layout
(B, L, H*64), L a multiple of the tile rows (and of 64 forward), and has a
``.launches`` counter.  The plain versions beside them compute each
variant's function with its roundings: the CPU tests hold them to the JAX
labs' bodies in interpret mode, and the card holds the kernels to them.
"""

from __future__ import annotations

import re

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build

HEAD_DIM = 64
LOG2E = 1.4426950408889634
SMEM_LIMIT = 232_448  # shared memory a block may ask for on an H100 (227 KiB)

# softmax policy -> the POLICY value of csrc/flash_fwd.cuh
POLICIES = {"base": 0, "nomax": 1, "exp2": 2, "tilemax": 3, "matonly": 4, "chunk": 5,
            "sbf16": 6}
# what csrc/flash_lab_fwd.cu and csrc/flash_lab_bwd.cu compile
VARIANT_COMBOS = (("base", 1), ("matonly", 1), ("nomax", 1), ("exp2", 1), ("tilemax", 1),
                  ("base", 2), ("chunk", 1), ("sbf16", 1))  # (policy, K/V stage depth)
VARIANT_TILING = (1, 32, 8)  # (heads per block, q rows, warps) of every variant
FWD_TILINGS = ((1, 32, 8), (12, 256, 16), (4, 256, 16), (6, 256, 16), (2, 256, 16))
BWD_TILINGS = ((64, 8, 1), (64, 8, 2), (32, 8, 1), (32, 4, 1))  # (rows, warps, pipe)
BWD_CONTROLS = ((64, 8, 1),)


def _refuse(what: str, combo, compiled) -> None:
    if combo not in compiled:
        raise ValueError(f"{what} {combo} is not compiled; the compiled ones are "
                         f"{list(compiled)}")


def check_variant(policy: str, depth: int) -> None:
    _refuse("flash variant (policy, depth)", (policy, depth), VARIANT_COMBOS)


def check_fwd_tiling(hpb: int, rows: int, warps: int) -> None:
    _refuse("forward tiling (heads per block, rows, warps)", (hpb, rows, warps), FWD_TILINGS)


def check_bwd_tiling(rows: int, warps: int, pipe: int, control: bool = False) -> None:
    _refuse("backward control (rows, warps, pipe)" if control else
            "backward tiling (rows, warps, pipe)", (rows, warps, pipe),
            BWD_CONTROLS if control else BWD_TILINGS)


def fwd_smem_bytes(rows: int, policy: str = "base", stages: int = 1, d: int = HEAD_DIM) -> int:
    """Shared memory of one forward block (``FlashLayout`` of
    ``csrc/flash_fwd.cuh``)."""
    ldq, ldo, kv = d + 8, d + 4, 64
    extra = 2 * rows if policy == "chunk" else (64 if policy == "tilemax" else 0)
    return (rows * ldq * 2 + stages * kv * ldq * 2 + rows * ldo * 4 + rows * (kv + 4) * 4
            + (rows * (kv + 8) * 2 if policy == "sbf16" else 0) + rows * (kv + 8) * 2
            + (3 * rows + extra) * 4)


def bwd_smem_bytes(rows: int, pipe: int = 1, d: int = HEAD_DIM) -> int:
    """Shared memory of one backward block (``BwdLayout`` of
    ``csrc/flash_bwd.cuh``)."""
    tile = rows * (d + 8) * 2
    return (4 * tile + 2 * rows * (rows + 4) * 4 + 2 * rows * (rows + 8) * 2
            + rows * (d + 4) * 4 + 2 * rows * 4 + (pipe - 1) * 2 * tile)


# ---------------------------------------------------------------------------
# plain versions


def _heads(t, heads: int):
    b, l, c = t.shape
    return t.reshape(b, l, heads, c // heads).float()


def flash_variant_plain(q, k, v, variant: str, scale: float, heads: int, rows: int = 32):
    """o (B, L, H*D) in v's dtype of one forward variant, from (B, L, H*D)
    q, k, v: p from the float32 scores s = q k^T scale by the variant's
    rule, rounded to bf16 for the P.V product (float32 sums), the row sum
    over the float32 p applied at the end.

    base: exp(s - rowmax); exp2: exp2(s' - rowmax') with s' = q k^T
    (scale log2 e); tilemax: exp(s - m) with m the max over each tile of
    ``rows`` q rows and every key; nomax and chunk: exp(min(s, 30) - 30);
    matonly: s itself (no softmax; its row sum of raw scores is
    ill-conditioned); sbf16: s rounded to bf16, then exp of (s - rowmax)
    computed in bf16."""
    if variant not in POLICIES:
        raise ValueError(f"unknown flash variant {variant!r} (one of {list(POLICIES)})")
    b, l, c = q.shape
    raw = torch.einsum("bqhd,bkhd->bhqk", _heads(q, heads), _heads(k, heads))
    s = raw * scale
    if variant == "base":
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    elif variant == "exp2":
        s2 = raw * torch.tensor(scale * LOG2E, dtype=torch.float32)
        p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    elif variant == "tilemax":
        tiles = s.reshape(b, heads, l // rows, rows, l)
        p = torch.exp(tiles - tiles.amax(dim=(-1, -2), keepdim=True)).reshape(s.shape)
    elif variant in ("nomax", "chunk"):
        p = torch.exp(torch.clamp(s, max=30.0) - 30.0)
    elif variant == "matonly":
        p = s
    else:  # sbf16
        sb = s.to(torch.bfloat16)
        p = torch.exp((sb - sb.amax(dim=-1, keepdim=True)).float())
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), _heads(v, heads))
    o = o / p.sum(dim=-1).permute(0, 2, 1)[..., None]
    return o.reshape(b, l, c).to(v.dtype)


def flash_bwd_control_plain(q, k, v, do, heads: int):
    """(dq, dk, dv) of the backward control, each (B, L, H*D) in q's dtype:
    s = q k^T and dp = do v^T unscaled, each rounded to bf16; dv = s^T do,
    dk = dp^T q, dq = dp k, in float32 sums.  No softmax: the floor of the
    kernels' structure, not a gradient."""
    b, l, c = q.shape
    qf, kf, vf, dof = (_heads(t, heads) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).to(torch.bfloat16).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf).to(torch.bfloat16).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", s, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", dp, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", dp, kf)
    return tuple(t.reshape(b, l, c).to(q.dtype) for t in (dq, dk, dv))


# ---------------------------------------------------------------------------
# the kernels


def _check(name: str, heads: int, *tensors) -> tuple:
    """(B, L, H) of contiguous bf16 (B, L, heads * 64) CUDA tensors on one
    device, else raise."""
    q = tensors[0]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dim() != 3 or q.shape[2] != heads * HEAD_DIM:
        raise ValueError(f"{name}: want (B, L, {heads} * {HEAD_DIM}), got {tuple(q.shape)}")
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous bf16 tensors of one shape, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return q.shape[0], q.shape[1], heads


def _lab_fwd(name, q, k, v, policy, stages, hpb, rows, warps, scale, heads):
    b, l, h = _check(name, heads, q, k, v)
    if l % rows or l % 64 or h % hpb:
        raise ValueError(f"{name}: L={l} must be a multiple of {rows} and of 64, "
                         f"H={h} of {hpb}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().gvq_flash_lab_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l, h, HEAD_DIM,
            float(scale), POLICIES[policy], stages, hpb, rows, warps, _build.stream_of(q))
    _build.check(err, "gvq_flash_lab_fwd")
    return o


def flash_variant_cuda(q, k, v, variant: str, depth: int, scale: float, heads: int):
    """B15: o of one softmax variant at K/V stage depth 1 or 2, at the
    shipped tiling (32 q rows, 8 warps, one head a block)."""
    check_variant(variant, depth)
    o = _lab_fwd("flash variant kernel", q, k, v, variant, depth, *VARIANT_TILING, scale, heads)
    flash_variant_cuda.launches += 1
    return o


flash_variant_cuda.launches = 0


def flash_fwd_tiling_cuda(q, k, v, hpb: int, rows: int, warps: int, scale: float, heads: int):
    """B16: o of the shipped forward (base softmax, one K/V buffer) at
    ``hpb`` heads a block, ``rows`` q rows a block and ``warps`` warps."""
    check_fwd_tiling(hpb, rows, warps)
    o = _lab_fwd("flash forward tiling kernel", q, k, v, "base", 1, hpb, rows, warps, scale,
                 heads)
    flash_fwd_tiling_cuda.launches += 1
    return o


flash_fwd_tiling_cuda.launches = 0


def _lab_bwd(name, q, k, v, o, z, do, rows, warps, pipe, control, scale, heads):
    b, l, h = _check(name, heads, q, k, v, do, *(() if control else (o,)))
    if l % rows:
        raise ValueError(f"{name}: L={l} must be a multiple of {rows}")
    if not control and (z.device != q.device or z.dtype != torch.float32
                        or tuple(z.shape) != (b, h, l) or not z.is_contiguous()):
        raise ValueError(f"{name}: z must be a contiguous ({b}, {h}, {l}) float32 tensor "
                         f"on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = None if control else torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library().gvq_flash_lab_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if control else o.data_ptr(),
            None if control else z.data_ptr(), do.data_ptr(),
            None if control else di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, l, h, HEAD_DIM, float(scale), rows, warps, pipe, int(control),
            _build.stream_of(q))
    _build.check(err, "gvq_flash_lab_bwd")
    return dq, dk, dv


def flash_bwd_tiling_cuda(q, k, v, o, z, do, rows: int, warps: int, pipe: int, scale: float,
                          heads: int):
    """B17: (dq, dk, dv) of the shipped backward (di pre-pass, dk/dv, dq) at
    ``rows``-row tiles, ``warps`` warps and ``pipe`` streamed tile pairs in
    flight, from the forward's o and z (B, H, L) float32."""
    check_bwd_tiling(rows, warps, pipe)
    out = _lab_bwd("flash backward tiling kernel", q, k, v, o, z, do, rows, warps, pipe, False,
                   scale, heads)
    flash_bwd_tiling_cuda.launches += 1
    return out


flash_bwd_tiling_cuda.launches = 0


def flash_bwd_control_cuda(q, k, v, do, rows: int, warps: int, pipe: int, heads: int):
    """B17's control: the backward kernels with the softmax recompute
    deleted (``flash_bwd_control_plain``'s function, from the same seven
    products)."""
    check_bwd_tiling(rows, warps, pipe, control=True)
    out = _lab_bwd("flash backward control kernel", q, k, v, None, None, do, rows, warps, pipe,
                   True, 1.0, heads)
    flash_bwd_control_cuda.launches += 1
    return out


flash_bwd_control_cuda.launches = 0


# ---------------------------------------------------------------------------
# what ptxas reported for a combination (registers and spills, nvcc.log)


def _template_args(mangled: str, kernel: str):
    m = re.search(rf"{len(kernel)}{kernel}I((?:L[a-z]+\d+E)+)E", mangled)
    return None if m is None else [int(x) for x in re.findall(r"L[a-z]+(\d+)E", m.group(1))]


def fwd_kernel_args(policy: str, stages: int, hpb: int, rows: int, warps: int):
    """The template arguments of ``flash_fwd_kernel`` for a combination."""
    return [HEAD_DIM, 0, rows, warps, hpb, POLICIES[policy], stages]


def bwd_kernel_args(rows: int, warps: int, pipe: int, control: bool):
    """The template arguments of the two backward kernels for a combination."""
    return [HEAD_DIM, rows, warps, 0, pipe, int(control)]


def ptxas_of(usage: dict, kernel: str, args) -> dict:
    """``_build.ptxas_usage``'s entry for one instantiation, or {} where the
    log does not name it."""
    for name, entry in usage.items():
        if _template_args(name, kernel) == list(args):
            return entry
    return {}
