"""B16 on the card: the shipped flash forward body at explicit tilings, at
the bsqvit shape (B=16, L=1024, H=12, D=64) bf16.

The port of ``scripts/exp_flash_fwd_tilings.py`` (its ``run``):

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_fwd_tilings          # defaults
    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_fwd_tilings 12:256 1:32:8

A combo is ``hpb:rows[:warps]``: heads per block (a block runs its heads
one after another), q rows per block, and warps (by default 16 for 256 rows
and more, else 8).  The JAX lab's defaults are (hpb, block_q) = (12, 256),
(4, 256), (6, 256), (2, 256), (4, 512) and (12, 512).  Each gets its
Hopper counterpart, or a line saying why it has none: the shipped body
keeps a block's Q tile, one 64-row K/V tile, the float32 output
accumulator, the float32 scores and the bf16 probabilities in shared
memory, so 256 rows take 225,280 bytes (just under the 232,448 a block may
have, at one K/V buffer) and 512 rows 441,344.  (1, 32, 8), the shipped
tiling, is the reference row.

Each line reports microseconds per layer (CUDA events over 12 chained
layers, best of 3 trials of 10 after a warm-up) and ``max_err`` against
the float32 einsum softmax reference, as the JAX lab does, with the bound
and SDPA's time.  It runs on a CUDA card only.
"""

from __future__ import annotations

import sys

import torch

from vqvae_from_gaussian_vae_tpu_torch.labs import _common as C
from vqvae_from_gaussian_vae_tpu_torch.labs._timing import best_ms
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

LAYERS = 12
REFERENCE = (1, 32, 8)  # the shipped tiling
JAX_DEFAULTS = [(12, 256), (4, 256), (6, 256), (2, 256), (4, 512), (12, 512)]


def default_warps(rows: int) -> int:
    return 16 if rows >= 256 else 8


def no_counterpart(hpb: int, rows: int, warps: int):
    """Why a tiling has no Hopper counterpart (with its number), or None."""
    need = FL.fwd_smem_bytes(rows)
    if need > FL.SMEM_LIMIT:
        return (f"hpb={hpb} bq={rows}: no counterpart: {rows} q rows need {need} bytes of "
                f"shared memory a block, against {FL.SMEM_LIMIT}")
    if C.H % hpb:
        return f"hpb={hpb} bq={rows}: no counterpart: {hpb} does not divide H={C.H}"
    return None


def parse_combos(args):
    """``hpb:rows[:warps]`` arguments (the JAX lab's ``hpb:block_q`` syntax,
    with an optional warp count) -> [(hpb, rows, warps)].  A tiling that
    cannot fit stays in the list (``run`` reports why); one that could but
    is not compiled is refused."""
    combos = []
    for a in args:
        parts = [int(x) for x in a.split(":")]
        hpb, rows = parts[0], parts[1]
        warps = parts[2] if len(parts) > 2 else default_warps(rows)
        if no_counterpart(hpb, rows, warps) is None:
            FL.check_fwd_tiling(hpb, rows, warps)
        combos.append((hpb, rows, warps))
    return combos


def default_combos():
    return [REFERENCE] + [(hpb, rows, default_warps(rows)) for hpb, rows in JAX_DEFAULTS]


def run(hpb: int, rows: int, warps: int, inputs=None, reference=None,
        layers: int = LAYERS) -> dict:
    """Time one tiling and check it; a tiling with no counterpart returns
    its reason instead."""
    reason = no_counterpart(hpb, rows, warps)
    combo = f"{hpb}:{rows}:{warps}"
    if reason is not None:
        return {"lab": "exp_flash_fwd_tilings", "combo": combo, "skipped": reason}
    C.require_card()
    FL.check_fwd_tiling(hpb, rows, warps)
    q, k, v = inputs if inputs is not None else C.lab_inputs(3)
    ref = reference if reference is not None else C.einsum_reference(q, k, v)
    torch.cuda.reset_peak_memory_stats()

    def chain():
        x = q
        for _ in range(layers):
            x = FL.flash_fwd_tiling_cuda(x, k, v, hpb, rows, warps, C.SCALE, C.H)
        return x

    us = 1e3 * best_ms(chain) / layers
    out = FL.flash_fwd_tiling_cuda(q, k, v, hpb, rows, warps, C.SCALE, C.H)
    bound, by = C.bound_ms(*C.fwd_flops_bytes())
    return {"lab": "exp_flash_fwd_tilings", "combo": combo, "us_per_layer": us,
            "bound_us": 1e3 * bound, "bound_by": by, "max_err": C.max_abs(out, ref),
            "checked": True, "smem_bytes": FL.fwd_smem_bytes(rows),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "ptxas": FL.ptxas_of(C.ptxas_usage(), "flash_fwd_kernel",
                                 FL.fwd_kernel_args("base", 1, hpb, rows, warps)),
            "out": out}


def main(argv=None) -> int:
    combos = parse_combos(sys.argv[1:] if argv is None else argv) or default_combos()
    C.require_card()
    q, k, v = C.lab_inputs(3)
    ref = C.einsum_reference(q, k, v)
    sdpa_us = 1e3 * C.sdpa_fwd_ms(q, k, v)
    print(f"# {torch.cuda.get_device_name(0)}; SDPA forward {sdpa_us:.1f} us", flush=True)
    for hpb, rows, warps in combos:
        r = run(hpb, rows, warps, (q, k, v), ref)
        if "skipped" in r:
            print(r["skipped"], flush=True)
            continue
        print(f"hpb={hpb:2d} bq={rows:4d} w{warps:2d}: {r['us_per_layer']:8.1f} us/layer  "
              f"max_err {r['max_err']:.3e}  bound {r['bound_us']:.1f} us  "
              f"SDPA {sdpa_us:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
