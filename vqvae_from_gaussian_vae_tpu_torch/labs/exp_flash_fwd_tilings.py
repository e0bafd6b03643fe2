"""B16 on the card: the shipped flash forward body at explicit tilings, at
the bsqvit shape (B=16, L=1024, H=12, D=64) bf16.

The port of ``scripts/exp_flash_fwd_tilings.py`` (its ``run``):

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_fwd_tilings          # defaults
    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_fwd_tilings 12:256 1:192:128

A combo is ``hpb:rows[:keys]``, the JAX lab's ``hpb:block_q`` with the key
tile: heads per block, q rows per block and keys a K and V tile (by default
64 for 256 rows and more, else 128).  The body is the shipped forward of
``csrc/flash_fwd_sm90.cuh`` (``F9Knobs``): 64 q rows a consumer warpgroup
plus one producer warpgroup; a block walks its ``hpb`` heads one after
another, the ring of K and V tiles flowing across each head boundary and
the next head's Q landing in a second Q tile (the lever a persistent block
would pull).  (1, 192, 128), the shipped tiling, is the reference row;
(1, 128, 128) is the depth-2 variant's tiling at depth 1, and (1, 256, 64)
the 256-row block at one head, beside which the JAX lab's defaults price
heads per block alone.  Those defaults are (hpb, block_q) = (12, 256),
(4, 256), (6, 256), (2, 256), (4, 512) and (12, 512).  256 rows are four
consumer warpgroups, 640 threads, which launch at 96 registers a thread
and leave 112 a consumer thread after setmaxnreg: 64-key tiles, whose
score tile is 32 floats.
512 rows would be eight consumer warpgroups and the producer's, 1152
threads, over the 1024 a block may have: those print a line saying so.

Each line reports microseconds per layer (CUDA events over 12 chained
layers, best of 3 trials of 10 after a warm-up) and ``max_err`` against
the float32 einsum softmax reference, as the JAX lab does, with the bound,
SDPA's time, the blocks and ptxas's registers and spills.  It runs on a
CUDA card only.
"""

from __future__ import annotations

import sys

import torch

from vqvae_from_gaussian_vae_tpu_torch.labs import _common as C
from vqvae_from_gaussian_vae_tpu_torch.labs._timing import best_ms
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

LAYERS = 12
REFERENCE = FL.VARIANT_TILING  # the shipped tiling
JAX_DEFAULTS = [(12, 256), (4, 256), (6, 256), (2, 256), (4, 512), (12, 512)]


def default_keys(rows: int) -> int:
    return 64 if rows >= 256 else 128


def no_counterpart(hpb: int, rows: int, keys: int):
    """Why a tiling has no Hopper counterpart (with its number), or None."""
    head = f"hpb={hpb} bq={rows}: no counterpart: "
    if rows % 64:
        return head + f"{rows} q rows are not whole 64-row consumer warpgroups"
    lay = FL.fwd_layout(hpb, rows, keys)
    if lay["threads"] > FL.MAX_THREADS:
        return (head + f"{rows} q rows are {lay['warpgroups']} consumer warpgroups and the "
                f"producer's, {lay['threads']} threads a block, against {FL.MAX_THREADS}")
    if lay["smem"] > FL.SMEM_LIMIT:
        return (head + f"{lay['smem']} bytes of shared memory a block, against "
                f"{FL.SMEM_LIMIT}")
    if C.H % hpb:
        return head + f"{hpb} does not divide H={C.H}"
    return None


def parse_combos(args):
    """``hpb:rows[:keys]`` arguments (the JAX lab's ``hpb:block_q`` syntax,
    with an optional key tile) -> [(hpb, rows, keys)].  A tiling that cannot
    fit stays in the list (``run`` reports why); one that could but is not
    compiled is refused."""
    combos = []
    for a in args:
        parts = [int(x) for x in a.split(":")]
        hpb, rows = parts[0], parts[1]
        keys = parts[2] if len(parts) > 2 else default_keys(rows)
        if no_counterpart(hpb, rows, keys) is None:
            FL.check_fwd_tiling(hpb, rows, keys)
        combos.append((hpb, rows, keys))
    return combos


def default_combos():
    return ([REFERENCE, FL.DEEP_TILING, FL.ONE_HEAD_TILING]
            + [(hpb, rows, default_keys(rows)) for hpb, rows in JAX_DEFAULTS])


def run(hpb: int, rows: int, keys: int, inputs=None, reference=None,
        layers: int = LAYERS) -> dict:
    """Time one tiling and check it; a tiling with no counterpart returns
    its reason instead."""
    reason = no_counterpart(hpb, rows, keys)
    combo = f"{hpb}:{rows}:{keys}"
    if reason is not None:
        return {"lab": "exp_flash_fwd_tilings", "combo": combo, "skipped": reason}
    C.require_card()
    FL.check_fwd_tiling(hpb, rows, keys)
    q, k, v = inputs if inputs is not None else C.lab_inputs(3)
    ref = reference if reference is not None else C.einsum_reference(q, k, v)
    torch.cuda.reset_peak_memory_stats()

    def chain():
        x = q
        for _ in range(layers):
            x = FL.flash_fwd_tiling_cuda(x, k, v, hpb, rows, keys, C.SCALE, C.H)
        return x

    us = 1e3 * best_ms(chain) / layers
    out = FL.flash_fwd_tiling_cuda(q, k, v, hpb, rows, keys, C.SCALE, C.H)
    bound, by = C.bound_ms(*C.fwd_flops_bytes())
    plan = FL.lab_fwd_plan(C.B, C.H, C.L, hpb, rows, keys)
    args = FL.fwd_kernel_args("base", 1, hpb, rows, keys)
    return {"lab": "exp_flash_fwd_tilings", "combo": combo, "us_per_layer": us,
            "bound_us": 1e3 * bound, "bound_by": by, "max_err": C.max_abs(out, ref),
            "checked": True, "smem_bytes": plan.smem, "blocks": plan.grid[0] * plan.grid[1],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "kernel_args": args, "ptxas": FL.ptxas_of(C.ptxas_usage(), FL.FWD_KERNEL, args),
            "out": out}


def main(argv=None) -> int:
    combos = parse_combos(sys.argv[1:] if argv is None else argv) or default_combos()
    C.require_card()
    q, k, v = C.lab_inputs(3)
    ref = C.einsum_reference(q, k, v)
    sdpa_us = 1e3 * C.sdpa_fwd_ms(q, k, v)
    print(f"# {torch.cuda.get_device_name(0)}; SDPA forward {sdpa_us:.1f} us", flush=True)
    for hpb, rows, keys in combos:
        r = run(hpb, rows, keys, (q, k, v), ref)
        if "skipped" in r:
            print(r["skipped"], flush=True)
            continue
        print(f"hpb={hpb:2d} bq={rows:4d} keys {keys:3d}: {r['us_per_layer']:8.1f} us/layer  "
              f"max_err {r['max_err']:.3e}  bound {r['bound_us']:.1f} us  "
              f"SDPA {sdpa_us:.1f} us  {C.kernel_facts(r)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
