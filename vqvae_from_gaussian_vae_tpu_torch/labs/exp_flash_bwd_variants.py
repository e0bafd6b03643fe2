"""B17 on the card: the shipped flash backward at explicit tilings, and its
no-softmax control, at the bsqvit shape (B=16, L=1024, H=12, D=64) bf16.

The port of ``scripts/exp_flash_bwd_variants.py`` (its ``run`` and
``_control_kernel``):

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_bwd_variants          # defaults
    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_bwd_variants 128:32:4 \
        128:64:3:control

A combo is ``rows:tile:stages[:control]``, the JAX lab's three numbers
in the body's terms.  The body is the shipped backward of
``csrc/flash_bwd_sm90.cuh`` (``B9Knobs``): a di pre-pass, then a dK/dV
kernel whose blocks own ``rows`` keys and stream ``tile``-row q tiles, and
a dQ kernel whose blocks own ``rows`` q rows and stream 2 ``tile``-key
tiles (the shipped pairing at D = 64 and at D = 128), ``stages`` streamed
tiles in flight in each kernel's TMA ring; two consumer warpgroups of 64
rows and a producer warpgroup, one head a block.  (128, 64, 3) is the
shipped tiling at D = 64.  Each of the JAX lab's defaults (hpb, block_q,
pipe) is printed with its counterpart or the number that rules it out
(``jax_default_reasons``).

``control`` is the body's CONTROL knob: the softmax recompute deleted from
the same two kernels (no exp, no z read, no di pre-pass, no ds
elementwise); s = q k^T and dp = do v^T are only rounded to bf16, and dv =
s^T do, dk = dp^T q, dq = dp k.
Unlike the forward's ``matonly`` this function has no division, so the
control is held to its plain version (``flash_bwd_control_plain``) within
2e-2 of max |out|: it does the same work.  The TPU kernel runs five
products; the port's two kernels recompute s and do v^T, so they run
seven, the control included: each line reports both counts.

Layers chain through do as the JAX lab does (do += 1e-6 dq, rounded), 8
layers, best of 3 trials of 10 after a warm-up.  Each line reports
microseconds per layer, ``max_err`` (dq, dk, dv: max |error| over max
|grad| against the float32 einsum attention's gradient; the control:
against its plain version), the bound (1.29e11 FLOP for five products
over 202 MB at the bf16 peak: 130 us) and SDPA's backward time at the same
shape.  It runs on a CUDA card only.
"""

from __future__ import annotations

import sys

import torch

from vqvae_from_gaussian_vae_tpu_torch.labs import _common as C
from vqvae_from_gaussian_vae_tpu_torch.labs._timing import best_ms
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

LAYERS = 8
JAX_DEFAULTS = [(6, 128, 2), (6, 128, 1), (4, 256, 2), (4, 256, 1), (2, 512, 2), (6, 256, 1),
                (4, 128, 2), (2, 256, 2)]
DEFAULT_COMBOS = ([(*t, False) for t in FL.BWD_TILINGS]
                  + [(*t, True) for t in FL.BWD_CONTROLS])
PRODUCTS_PORT, PRODUCTS_TPU = 7, 5


def live_registers(tile: int = 64, d: int = C.D) -> int:
    """Registers a dK/dV consumer thread holds across its tile loop: dK and
    dV (D / 2 floats each), S^T and dP^T (tile / 2 floats each), the P and
    dS fragments (tile / 4 registers each)."""
    return d + tile + tile // 2


def jax_default_counterpart(hpb: int, bq: int, pipe: int):
    """(rows, tile, stages) of a JAX default on this body, or None: block_q
    128 is the body's 128 block rows; its heads per block run as the grid's
    heads, one a block; pipe heads in flight become pipe + 1 stages."""
    del hpb
    return (bq, 64, pipe + 1) if bq == FL.BWD_ROWS else None


def jax_default_reasons():
    """One line for each of the JAX lab's default (hpb, block_q, pipe): its
    counterpart, or why it has none, with the number."""
    lines = []
    for hpb, bq, pipe in JAX_DEFAULTS:
        head = f"hpb={hpb} bq={bq} p{pipe}: "
        twin = jax_default_counterpart(hpb, bq, pipe)
        wg = bq // 64
        threads = 128 * (wg + 1)
        if twin is not None:
            FL.check_bwd_tiling(*twin)
            lines.append(head + "counterpart {}:{}:{}: {} block rows are the body's two consumer "
                         "warpgroups; one head a block (the grid walks B*H = {} of them), "
                         "{} stages".format(*twin, bq, C.B * C.H, twin[2]))
        elif threads > FL.MAX_THREADS:
            lines.append(head + f"no counterpart: {bq} block rows are {wg} consumer warpgroups "
                         f"and the producer's, {threads} threads a block, against "
                         f"{FL.MAX_THREADS}")
        else:
            lines.append(head + f"no counterpart: {bq} block rows are {wg} consumer warpgroups "
                         f"and the producer's, {threads} threads, which leave "
                         f"{FL.setmaxnreg_split(wg, 24)[1]} registers a consumer thread "
                         "(the producer cut to 24, the least setmaxnreg allows), against the "
                         f"{live_registers()} its accumulators and fragments hold "
                         f"(the shipped two warpgroups have {FL.BWD_CONSUMER_REGS})")
    return lines


def parse_combos(args):
    """``rows:tile:stages[:control]`` arguments -> [(rows, tile, stages,
    control)], refusing a combo that is not compiled."""
    combos = []
    for a in args:
        parts = a.split(":")
        rows, tile, stages = (int(x) for x in parts[:3])
        control = len(parts) > 3 and parts[3] == "control"
        FL.check_bwd_tiling(rows, tile, stages, control)
        combos.append((rows, tile, stages, control))
    return combos


def lab_state(seed: int = 0):
    """q, k, v, do drawn as the JAX lab draws them, and the forward's o and
    z from the shipped training forward (``gvq_flash_fwd_res``)."""
    q, k, v, do = C.lab_inputs(4, seed)
    o, z = fa.flash_attention_res_cuda(q, k, v, C.SCALE, C.H)
    return q, k, v, do, o, z


def run(rows: int, tile: int, stages: int, control: bool = False, state=None, reference=None,
        layers: int = LAYERS) -> dict:
    """Time one combo and check it; ``reference`` is the float32 einsum
    gradient (a tiling) or the plain control's output (the control)."""
    C.require_card()
    FL.check_bwd_tiling(rows, tile, stages, control)
    q, k, v, do, o, z = state if state is not None else lab_state()
    torch.cuda.reset_peak_memory_stats()

    def once(d):
        if control:
            return FL.flash_bwd_control_cuda(q, k, v, d, rows, tile, stages, C.H)
        return FL.flash_bwd_tiling_cuda(q, k, v, o, z, d, rows, tile, stages, C.SCALE, C.H)

    def chain():
        d = do
        for _ in range(layers):
            dq, _, _ = once(d)
            d = (d + dq * 1e-6).to(d.dtype)  # serialise the layers
        return d

    us = 1e3 * best_ms(chain) / layers
    out = once(do)
    if reference is None:
        reference = (FL.flash_bwd_control_plain(q, k, v, do, C.H) if control
                     else C.einsum_grads(q, k, v, do))
    err = max(C.rel_max(g, w) for g, w in zip(out, reference))
    bound, by = C.bound_ms(*C.bwd_flops_bytes(PRODUCTS_TPU))
    usage = C.ptxas_usage()
    args = FL.bwd_kernel_args(tile, stages, control)
    plan = FL.lab_bwd_plan(C.B, C.H, C.L, tile, stages)
    return {"lab": "exp_flash_bwd_variants",
            "combo": f"{rows}:{tile}:{stages}" + (":control" if control else ""),
            "us_per_layer": us, "bound_us": 1e3 * bound, "bound_by": by, "max_err": err,
            "max_err_is": ("max |error| / max |out| against flash_bwd_control_plain" if control
                           else "max |error| / max |grad| against the float32 einsum gradient"),
            "checked": True, "products": {"port": PRODUCTS_PORT, "tpu": PRODUCTS_TPU},
            "smem_bytes": list(FL.bwd_smem_bytes(tile, stages)),
            "blocks": plan.kv_grid[0] * plan.kv_grid[1] + plan.q_grid[0] * plan.q_grid[1],
            "kernel_args": args,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "ptxas": {"dkdv": FL.ptxas_of(usage, FL.BWD_KERNELS[0], args),
                      "dq": FL.ptxas_of(usage, FL.BWD_KERNELS[1], args)},
            "out": out}


def main(argv=None) -> int:
    combos = parse_combos(sys.argv[1:] if argv is None else argv)
    C.require_card()
    if not combos:
        for line in jax_default_reasons():
            print(line, flush=True)
        combos = DEFAULT_COMBOS
    state = lab_state()
    q, k, v, do = state[:4]
    grads = C.einsum_grads(q, k, v, do)
    sdpa_us = 1e3 * C.sdpa_bwd_ms(q, k, v, do)
    print(f"# {torch.cuda.get_device_name(0)}; SDPA backward {sdpa_us:.1f} us; "
          f"{PRODUCTS_PORT} products a layer here, {PRODUCTS_TPU} on the TPU", flush=True)
    for rows, tile, stages, control in combos:
        r = run(rows, tile, stages, control, state, None if control else grads)
        kind = " CONTROL(no-softmax)" if control else ""
        print(f"rows={rows:3d} tile {tile:2d} s{stages}{kind}: "
              f"{r['us_per_layer']:8.1f} us/layer  max_err {r['max_err']:.3e}  "
              f"bound {r['bound_us']:.1f} us  SDPA {sdpa_us:.1f} us  {C.kernel_facts(r)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
