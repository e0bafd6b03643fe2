"""B17 on the card: the shipped flash backward at explicit tilings, and its
no-softmax control, at the bsqvit shape (B=16, L=1024, H=12, D=64) bf16.

The port of ``scripts/exp_flash_bwd_variants.py`` (its ``run`` and
``_control_kernel``):

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_bwd_variants          # defaults
    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_bwd_variants 64:8:2 64:8:1:control

A combo is ``rows:warps:pipe[:control]``, the JAX lab's syntax with the
port's knobs: tile rows T (of q and of k/v), warps, and the pipe depth,
the streamed q tiles (in the dk/dv kernel) or K/V tiles (in the dq kernel)
in flight, 1 or 2 (2: the next pair copied by ``cp.async`` while the
current pair's products run).  The port's backward runs one head a block,
so the JAX lab's heads per block has no counterpart; its defaults (hpb,
block_q, pipe) map to T = block_q, and every one of them is printed with
the shared memory its tile would need against the 232,448 bytes a block
may have.  (64, 8, 1) is the shipped tiling at D = 64.

``control`` deletes the softmax recompute from the same two kernels: no
exp, no z read, no di pre-pass, no ds elementwise; s = q k^T and dp = do
v^T are only rounded to bf16, and dv = s^T do, dk = dp^T q, dq = dp k.
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


def jax_default_reasons():
    """One line for each of the JAX lab's default (hpb, block_q, pipe): why
    it has no Hopper counterpart, with the number."""
    lines = []
    for hpb, bq, pipe in JAX_DEFAULTS:
        need = FL.bwd_smem_bytes(bq, pipe)
        assert need > FL.SMEM_LIMIT, (bq, pipe)
        lines.append(f"hpb={hpb} bq={bq} p{pipe}: no counterpart: {bq}-row tiles need {need} "
                     f"bytes of shared memory a block, against {FL.SMEM_LIMIT} (and the port "
                     "runs one head a block)")
    return lines


def parse_combos(args):
    """``rows:warps:pipe[:control]`` arguments -> [(rows, warps, pipe,
    control)], refusing a combo that is not compiled."""
    combos = []
    for a in args:
        parts = a.split(":")
        rows, warps, pipe = (int(x) for x in parts[:3])
        control = len(parts) > 3 and parts[3] == "control"
        FL.check_bwd_tiling(rows, warps, pipe, control)
        combos.append((rows, warps, pipe, control))
    return combos


def lab_state(seed: int = 0):
    """q, k, v, do drawn as the JAX lab draws them, and the forward's o and
    z from the shipped training forward (``gvq_flash_fwd_res``)."""
    q, k, v, do = C.lab_inputs(4, seed)
    o, z = fa.flash_attention_res_cuda(q, k, v, C.SCALE, C.H)
    return q, k, v, do, o, z


def run(rows: int, warps: int, pipe: int, control: bool = False, state=None, reference=None,
        layers: int = LAYERS) -> dict:
    """Time one combo and check it; ``reference`` is the float32 einsum
    gradient (a tiling) or the plain control's output (the control)."""
    C.require_card()
    FL.check_bwd_tiling(rows, warps, pipe, control)
    q, k, v, do, o, z = state if state is not None else lab_state()
    torch.cuda.reset_peak_memory_stats()

    def once(d):
        if control:
            return FL.flash_bwd_control_cuda(q, k, v, d, rows, warps, pipe, C.H)
        return FL.flash_bwd_tiling_cuda(q, k, v, o, z, d, rows, warps, pipe, C.SCALE, C.H)

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
    args = FL.bwd_kernel_args(rows, warps, pipe, control)
    return {"lab": "exp_flash_bwd_variants",
            "combo": f"{rows}:{warps}:{pipe}" + (":control" if control else ""),
            "us_per_layer": us, "bound_us": 1e3 * bound, "bound_by": by, "max_err": err,
            "max_err_is": ("max |error| / max |out| against flash_bwd_control_plain" if control
                           else "max |error| / max |grad| against the float32 einsum gradient"),
            "checked": True, "products": {"port": PRODUCTS_PORT, "tpu": PRODUCTS_TPU},
            "smem_bytes": FL.bwd_smem_bytes(rows, pipe),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "ptxas": {"dkdv": FL.ptxas_of(usage, "flash_bwd_dkdv_kernel", args),
                      "dq": FL.ptxas_of(usage, "flash_bwd_dq_kernel", args)},
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
    for rows, warps, pipe, control in combos:
        r = run(rows, warps, pipe, control, state, None if control else grads)
        print(f"T={rows:3d} w{warps:2d} p{pipe}{' CONTROL(no-softmax)' if control else ''}: "
              f"{r['us_per_layer']:8.1f} us/layer  max_err {r['max_err']:.3e}  "
              f"bound {r['bound_us']:.1f} us  SDPA {sdpa_us:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
