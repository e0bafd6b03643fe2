"""The flash labs' kernels: the shipped bf16 flash bodies at knobs no model
runs.

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
``csrc/flash_lab_bwd.cu`` (``gvq_flash_lab_bwd``): the bodies the shipped
entries run at D = 64, ``csrc/flash_fwd_sm90.cuh`` (``F9Knobs``: consumer
warpgroups, keys a tile, heads a block, softmax policy, score tiles in
flight) and ``csrc/flash_bwd_sm90.cuh`` (``B9Knobs``: streamed tile rows,
stages, the control), instantiated at the combinations listed here, and
only those.  A combination that is not compiled raises ``ValueError``
naming the compiled ones; nothing is put in its place.  Every wrapper takes
bf16 CUDA tensors in the token-major layout (B, L, H*64), any L, launches
through a plan (``lab_fwd_plan``, ``lab_bwd_plan``: the shipped bodies'
``FwdPlan`` and ``BwdPlan``) and has a ``.launches`` counter.  The plain
versions beside them compute each variant's function with its roundings:
the CPU tests hold them to the JAX labs' bodies in interpret mode, and the
card holds the kernels to them.
"""

from __future__ import annotations

import functools
import re

import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

HEAD_DIM = 64
LOG2E = 1.4426950408889634
SMEM_LIMIT = 232_448  # shared memory a block may ask for on an H100 (227 KiB)
MAX_THREADS = 1024  # threads a block may have
REGISTER_FILE = 65_536  # 32-bit registers of an SM

# softmax policy -> the kF9* value of csrc/flash_fwd_sm90.cuh
POLICIES = {"base": 0, "nomax": 1, "exp2": 2, "tilemax": 3, "matonly": 4, "chunk": 5,
            "sbf16": 6}
# what csrc/flash_lab_fwd.cu compiles: (policy, score tiles in flight) at
# VARIANT_TILING, depth 2 at DEEP_TILING (two score tiles need the 232
# registers a thread of two consumer warpgroups; three have 160)
VARIANT_COMBOS = (("base", 1), ("matonly", 1), ("nomax", 1), ("exp2", 1), ("tilemax", 1),
                  ("base", 2), ("chunk", 1), ("sbf16", 1))
VARIANT_TILING = (1, 192, 128)  # (heads per block, q rows, keys a tile): the shipped D = 64 one
DEEP_TILING = (1, 128, 128)
# the JAX lab's 256-row tilings walk several heads a block; ONE_HEAD_TILING
# is their block at one head, which prices heads per block alone
ONE_HEAD_TILING = (1, 256, 64)
FWD_TILINGS = (VARIANT_TILING, DEEP_TILING, ONE_HEAD_TILING, (12, 256, 64), (4, 256, 64),
               (6, 256, 64), (2, 256, 64))
FWD_STAGES = 3  # kF9Stages
# registers a thread after setmaxnreg, by consumer warpgroups
# (csrc/flash_fwd_sm90.cuh f9_consumer_regs, f9_producer_regs)
FWD_CONSUMER_REGS = {2: 232, 3: 160, 4: 112}
FWD_PRODUCER_REGS = {2: 40, 3: 24, 4: 24}
# what csrc/flash_lab_bwd.cu compiles: (block rows, streamed q rows of the
# dK/dV kernel, stages); the dQ kernel streams twice the rows in keys
BWD_ROWS, BWD_THREADS = 128, 384  # kB9Rows, kB9Threads
BWD_CONSUMER_REGS, BWD_PRODUCER_REGS = 232, 40  # kB9ConsumerRegs, kB9ProducerRegs
BWD_TILINGS = ((128, 64, 3), (128, 64, 2), (128, 32, 3), (128, 32, 4))
BWD_CONTROLS = ((128, 64, 3),)


def _refuse(what: str, combo, compiled) -> None:
    if combo not in compiled:
        raise ValueError(f"{what} {combo} is not compiled; the compiled ones are "
                         f"{list(compiled)}")


def check_variant(policy: str, depth: int) -> None:
    _refuse("flash variant (policy, depth)", (policy, depth), VARIANT_COMBOS)


def variant_tiling(policy: str, depth: int) -> tuple:
    """(heads per block, q rows, keys a tile) a compiled variant runs at."""
    check_variant(policy, depth)
    return DEEP_TILING if depth == 2 else VARIANT_TILING


def check_fwd_tiling(hpb: int, rows: int, keys: int) -> None:
    _refuse("forward tiling (heads per block, rows, keys)", (hpb, rows, keys), FWD_TILINGS)


def check_bwd_tiling(rows: int, tile: int, stages: int, control: bool = False) -> None:
    _refuse("backward control (rows, tile, stages)" if control else
            "backward tiling (rows, tile, stages)", (rows, tile, stages),
            BWD_CONTROLS if control else BWD_TILINGS)


def setmaxnreg_split(warpgroups: int, producer: int) -> tuple:
    """(registers a thread at launch, registers a consumer thread may take
    after setmaxnreg) of a block of ``warpgroups`` consumer warpgroups and a
    producer warpgroup cut to ``producer``: the launch gives each thread
    65,536 / threads, rounded down to 8, and the consumers may take only
    what the producer gives up (setmaxnreg.inc waits for it)."""
    threads = 128 * (warpgroups + 1)
    launch = REGISTER_FILE // threads // 8 * 8
    return launch, (launch * threads - 128 * producer) // (128 * warpgroups) // 8 * 8


def fwd_layout(hpb: int, rows: int, keys: int, policy: str = "base", d: int = HEAD_DIM) -> dict:
    """One forward block of ``csrc/flash_fwd_sm90.cuh`` (``F9Layout``): its
    consumer warpgroups, threads, registers a thread after setmaxnreg and
    shared memory (Q tiles, the ring, the mbarriers, tilemax's exchange,
    1024 bytes of alignment slack)."""
    wg = rows // 64
    qbufs = 2 if hpb > 1 else 1
    bars = qbufs + 3 * FWD_STAGES + (qbufs if qbufs > 1 else 0)
    smem = (qbufs * rows * d * 2 + FWD_STAGES * 2 * keys * d * 2 + bars * 8
            + (wg * 32 if policy == "tilemax" else 0) + 1024)
    return {"warpgroups": wg, "threads": 128 * (wg + 1),
            "consumer_regs": FWD_CONSUMER_REGS.get(wg), "producer_regs": FWD_PRODUCER_REGS.get(wg),
            "smem": smem}


def fwd_smem_bytes(hpb: int, rows: int, keys: int, policy: str = "base") -> int:
    return fwd_layout(hpb, rows, keys, policy)["smem"]


def bwd_smem_bytes(tile: int, stages: int, d: int = HEAD_DIM) -> tuple:
    """Shared memory of the backward body's two kernels
    (``B9KvLayout``, ``B9QLayout`` of ``csrc/flash_bwd_sm90.cuh``) at
    ``tile``-row q tiles (dK/dV) and 2 ``tile``-key tiles (dQ)."""
    nq, nk = tile, 2 * tile
    kv = ((2 * BWD_ROWS + 2 * stages * nq) * d * 2 + stages * 2 * nq * 4 + (1 + 3 * stages) * 8
          + 1024)
    q = (2 * BWD_ROWS + 2 * stages * nk) * d * 2 + (1 + 2 * stages) * 8 + 1024
    return kv, q


@functools.lru_cache(maxsize=None)
def lab_fwd_plan(b: int, h: int, l: int, hpb: int, rows: int, keys: int,
                 policy: str = "base") -> fa.FlashFwdPlan:
    """The forward lab's launch on token-major (B, L, H*64) q, k, v: the
    shipped body's plan at this tiling, a block's heads ``hpb`` (the grid's
    y is B * H / hpb)."""
    c = h * HEAD_DIM
    lay = fwd_layout(hpb, rows, keys, policy)
    row_dim, maps = fa._maps("token_major", b, h, HEAD_DIM,
                             ((l, rows, 0, c), (l, keys, 0, c), (l, keys, 0, c)))
    return fa.FlashFwdPlan("wgmma", rows, keys, FWD_STAGES, (-(-l // rows), b * h // hpb),
                           lay["threads"], lay["smem"], l % keys != 0, row_dim, maps,
                           (l * c, HEAD_DIM, c))


@functools.lru_cache(maxsize=None)
def lab_bwd_plan(b: int, h: int, l: int, tile: int, stages: int) -> fa.FlashBwdPlan:
    """The backward lab's launch on token-major tensors: the shipped body's
    plan with ``tile``-row q tiles (dK/dV), 2 ``tile``-key tiles (dQ) and
    ``stages`` stages."""
    c = h * HEAD_DIM
    kv_smem, q_smem = bwd_smem_bytes(tile, stages)
    row_dim, maps = fa._maps("token_major", b, h, HEAD_DIM,
                             ((l, tile, 0, c), (l, 2 * tile, 0, c), (l, 2 * tile, 0, c),
                              (l, tile, 0, c)))
    grid = (-(-l // BWD_ROWS), b * h)
    strides = (l * c, HEAD_DIM, c)
    return fa.FlashBwdPlan("wgmma", BWD_ROWS, tile, BWD_ROWS, 2 * tile, stages, grid, grid,
                           BWD_THREADS, kv_smem, q_smem, l % tile != 0, l % (2 * tile) != 0,
                           row_dim, maps, strides, strides, 1)


# ---------------------------------------------------------------------------
# plain versions


def _heads(t, heads: int):
    b, l, c = t.shape
    return t.reshape(b, l, heads, c // heads).float()


def flash_variant_plain(q, k, v, variant: str, scale: float, heads: int, rows: int = 64):
    """o (B, L, H*D) in v's dtype of one forward variant, from (B, L, H*D)
    q, k, v: p from the float32 scores s = q k^T scale by the variant's
    rule, rounded to bf16 for the P.V product (float32 sums), the row sum
    over the float32 p applied at the end.

    base: exp(s - rowmax); exp2: exp2(s' - rowmax') with s' = q k^T
    (scale log2 e); tilemax: exp(s - m) with m the max over each tile of
    ``rows`` q rows (a consumer warpgroup's 64) and every key; nomax and
    chunk: exp(min(s, 30) - 30); matonly: s itself (no softmax; its row
    sum of raw scores is ill-conditioned); sbf16: s rounded to bf16, then
    exp of (s - rowmax) computed in bf16."""
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
        p = torch.cat([torch.exp(t - t.amax(dim=(-1, -2), keepdim=True))
                       for t in s.split(rows, dim=2)], dim=2)
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
    """(B, L, H) of contiguous, 16-byte aligned bf16 (B, L, heads * 64) CUDA
    tensors on one device, else raise."""
    q = tensors[0]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dim() != 3 or q.shape[2] != heads * HEAD_DIM:
        raise ValueError(f"{name}: want (B, L, {heads} * {HEAD_DIM}), got {tuple(q.shape)}")
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous bf16 tensors of one shape, got "
                             f"{t.dtype} {tuple(t.shape)}")
    fa.check_aligned(name, *tensors)
    return q.shape[0], q.shape[1], heads


def _lab_fwd(name, q, k, v, policy, depth, hpb, rows, keys, scale, heads):
    b, l, h = _check(name, heads, q, k, v)
    if h % hpb:
        raise ValueError(f"{name}: H={h} must be a multiple of {hpb} heads a block")
    plan = lab_fwd_plan(b, h, l, hpb, rows, keys, policy).as_array()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().gvq_flash_lab_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l, h, HEAD_DIM,
            float(scale), POLICIES[policy], depth, hpb, rows, keys, plan, _build.stream_of(q))
    _build.check(err, "gvq_flash_lab_fwd")
    return o


def flash_variant_cuda(q, k, v, variant: str, depth: int, scale: float, heads: int):
    """B15: o of one softmax variant at depth 1 or 2 (score tiles in
    flight), on the shipped forward body at ``variant_tiling``."""
    tiling = variant_tiling(variant, depth)
    o = _lab_fwd("flash variant kernel", q, k, v, variant, depth, *tiling, scale, heads)
    flash_variant_cuda.launches += 1
    return o


flash_variant_cuda.launches = 0


def flash_fwd_tiling_cuda(q, k, v, hpb: int, rows: int, keys: int, scale: float, heads: int):
    """B16: o of the shipped forward (base softmax, depth 1) at ``hpb``
    heads a block, ``rows`` q rows a block (64 a consumer warpgroup) and
    ``keys`` keys a K and V tile."""
    check_fwd_tiling(hpb, rows, keys)
    o = _lab_fwd("flash forward tiling kernel", q, k, v, "base", 1, hpb, rows, keys, scale,
                 heads)
    flash_fwd_tiling_cuda.launches += 1
    return o


flash_fwd_tiling_cuda.launches = 0


def _lab_bwd(name, q, k, v, o, z, do, rows, tile, stages, control, scale, heads):
    b, l, h = _check(name, heads, q, k, v, do, *(() if control else (o,)))
    if not control and (z.device != q.device or z.dtype != torch.float32
                        or tuple(z.shape) != (b, h, l) or not z.is_contiguous()):
        raise ValueError(f"{name}: z must be a contiguous ({b}, {h}, {l}) float32 tensor "
                         f"on {q.device}")
    plan = lab_bwd_plan(b, h, l, tile, stages).as_array()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = None if control else torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library().gvq_flash_lab_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if control else o.data_ptr(),
            None if control else z.data_ptr(), do.data_ptr(),
            None if control else di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, l, h, HEAD_DIM, float(scale), rows, tile, stages, int(control), plan,
            _build.stream_of(q))
    _build.check(err, "gvq_flash_lab_bwd")
    return dq, dk, dv


def flash_bwd_tiling_cuda(q, k, v, o, z, do, rows: int, tile: int, stages: int, scale: float,
                          heads: int):
    """B17: (dq, dk, dv) of the shipped backward (di pre-pass, dK/dV, dQ) at
    ``rows`` keys or q rows a block, ``tile``-row q tiles (dK/dV) and 2
    ``tile``-key tiles (dQ), ``stages`` of them in flight, from the
    forward's o and z (B, H, L) float32."""
    check_bwd_tiling(rows, tile, stages)
    out = _lab_bwd("flash backward tiling kernel", q, k, v, o, z, do, rows, tile, stages, False,
                   scale, heads)
    flash_bwd_tiling_cuda.launches += 1
    return out


flash_bwd_tiling_cuda.launches = 0


def flash_bwd_control_cuda(q, k, v, do, rows: int, tile: int, stages: int, heads: int):
    """B17's control: the backward body with the softmax recompute deleted
    (``flash_bwd_control_plain``'s function, from the same seven
    products)."""
    check_bwd_tiling(rows, tile, stages, control=True)
    out = _lab_bwd("flash backward control kernel", q, k, v, None, None, do, rows, tile, stages,
                   True, 1.0, heads)
    flash_bwd_control_cuda.launches += 1
    return out


flash_bwd_control_cuda.launches = 0


# ---------------------------------------------------------------------------
# what ptxas reported for a combination (registers and spills, nvcc.log)


def _template_args(mangled: str, kernel: str):
    m = re.search(rf"{len(kernel)}{kernel}I((?:L[a-z]+\d+E)+)E", mangled)
    return None if m is None else [int(x) for x in re.findall(r"L[a-z]+(\d+)E", m.group(1))]


FWD_KERNEL = "flash_lab_fwd_kernel"
BWD_KERNELS = ("flash_lab_dkdv_kernel", "flash_lab_dq_kernel")


def fwd_kernel_args(policy: str, depth: int, hpb: int, rows: int, keys: int):
    """The template arguments of ``flash_lab_fwd_kernel`` for a combination
    at an L with no ragged key tile (kMask, WG, KEYS, HEADS, POLICY, DEPTH)."""
    return [0, rows // 64, keys, hpb, POLICIES[policy], depth]


def bwd_kernel_args(tile: int, stages: int, control: bool):
    """The template arguments of the two backward kernels for a combination
    at an L with no ragged tile (kMask, NQ, STAGES, CONTROL)."""
    return [0, tile, stages, int(control)]


def ptxas_of(usage: dict, kernel: str, args) -> dict:
    """``_build.ptxas_usage``'s entry for one instantiation, or {} where the
    log does not name it."""
    for name, entry in usage.items():
        if _template_args(name, kernel) == list(args):
            return entry
    return {}
