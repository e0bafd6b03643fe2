"""B15 on the card: the flash forward under other softmax policies and K/V
stage depths, at the bsqvit shape (B=16, L=1024, H=12, D=64) bf16.

The port of ``scripts/exp_flash_variants.py`` (its kernel ``make_kernel``):

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_variants base:1 matonly:1 ...

A combo is ``policy:depth``.  Each policy is a value of the shipped
forward body's POLICY knob (``csrc/flash_fwd_sm90.cuh``, ``F9Knobs``), run
at the shipped D = 64 tiling (one head a block, 192 q rows in three
consumer warpgroups, 128-key tiles in a 3-stage TMA ring):

  base      the shipped online softmax (``f9_softmax``): per-row running
            max, then the accurate ``expf``
  nomax     p = expf(min(s, 30) - 30): no max pass, no rescale of O
  exp2      exp2f(s' - m'), the scores scaled by scale log2 e
  tilemax   one running max per consumer warpgroup's 64 rows and key tile
            (the warps' maxima meet in shared memory behind a named
            barrier), a scalar rescale
  matonly   p = bf16(s): no softmax; the control (its rows divide by a row
            sum of raw scores, so its output is timed, not checked)
  chunk     nomax's function on each 128-key tile's two 64-key halves: the
            first half's P V runs while the second half's exp does
  sbf16     the float32 accumulator's scores rounded to bf16 before the max
            and exp, (s - m) rounded to bf16 (wgmma has no bf16
            accumulator, so this prices the rounding, not fewer bytes)

What they mean on Hopper.  On the TPU ``sbf16`` was illegal (Mosaic needs
a 32-bit matmul accumulator) and ``chunk`` crashed the worker; here both
run.  The TPU's pipeline depth bought MXU/VPU overlap across heads; here
depth is the score tiles in flight: 1, the shipped order (tile t's Q K^T
issued beside tile t-1's P V, tile t's softmax while P V runs); 2, tile
t+1's Q K^T issued as well before tile t's softmax, in a second register
set.  Two 64-float score tiles do not fit three consumer warpgroups' 160
registers a thread, so depth 2 runs at two warpgroups (128 q rows, 232
registers), and the tilings lab's (1, 128, 128) row is its depth-1 twin.

Each line reports microseconds per layer (CUDA events over 12 chained
layers, q fed forward, best of 3 trials of 10 after a warm-up), the bound
(5.15e10 FLOP over 101 MB at the bf16 peak: 52 us), SDPA's time at the
same shape, and ``max_err`` against the float32 einsum softmax reference,
as the JAX lab does.  The default combos are the JAX lab's, plus
``chunk:1`` and ``sbf16:1``.  It runs on a CUDA card only.
"""

from __future__ import annotations

import sys

import torch

from vqvae_from_gaussian_vae_tpu_torch.labs import _common as C
from vqvae_from_gaussian_vae_tpu_torch.labs._timing import best_ms
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

LAYERS = 12
DEFAULT_COMBOS = list(FL.VARIANT_COMBOS)  # the JAX lab's, then chunk:1 and sbf16:1


def parse_combos(args):
    """``policy:depth`` arguments (the JAX lab's syntax) -> [(policy, depth)],
    refusing a combo that is not compiled."""
    combos = []
    for a in args:
        policy, depth = a.rsplit(":", 1)
        FL.check_variant(policy, int(depth))
        combos.append((policy, int(depth)))
    return combos


def run(variant: str, depth: int, inputs=None, reference=None, layers: int = LAYERS) -> dict:
    """Time one combo and check it; returns its report, ``out`` being the
    output of the checked launch."""
    C.require_card()
    FL.check_variant(variant, depth)
    q, k, v = inputs if inputs is not None else C.lab_inputs(3)
    ref = reference if reference is not None else C.einsum_reference(q, k, v)
    torch.cuda.reset_peak_memory_stats()

    def chain():
        x = q
        for _ in range(layers):
            x = FL.flash_variant_cuda(x, k, v, variant, depth, C.SCALE, C.H)
        return x

    us = 1e3 * best_ms(chain) / layers
    out = FL.flash_variant_cuda(q, k, v, variant, depth, C.SCALE, C.H)
    bound, by = C.bound_ms(*C.fwd_flops_bytes())
    usage = C.ptxas_usage()
    plan = FL.lab_fwd_plan(C.B, C.H, C.L, *FL.variant_tiling(variant, depth), variant)
    args = FL.fwd_kernel_args(variant, depth, *FL.variant_tiling(variant, depth))
    return {"lab": "exp_flash_variants", "combo": f"{variant}:{depth}", "us_per_layer": us,
            "bound_us": 1e3 * bound, "bound_by": by, "max_err": C.max_abs(out, ref),
            "checked": variant != "matonly", "blocks": plan.grid[0] * plan.grid[1],
            "smem_bytes": plan.smem,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "tiling": list(FL.variant_tiling(variant, depth)), "kernel_args": args,
            "ptxas": FL.ptxas_of(usage, FL.FWD_KERNEL, args),
            "out": out}


def main(argv=None) -> int:
    combos = parse_combos(sys.argv[1:] if argv is None else argv) or DEFAULT_COMBOS
    C.require_card()
    q, k, v = C.lab_inputs(3)
    ref = C.einsum_reference(q, k, v)
    sdpa_us = 1e3 * C.sdpa_fwd_ms(q, k, v)
    print(f"# {torch.cuda.get_device_name(0)}; SDPA forward {sdpa_us:.1f} us", flush=True)
    for variant, depth in combos:
        r = run(variant, depth, (q, k, v), ref)
        print(f"{variant:8s} p{depth}: {r['us_per_layer']:8.1f} us/layer  "
              f"max_err {r['max_err']:.3e}  bound {r['bound_us']:.1f} us  "
              f"SDPA {sdpa_us:.1f} us  {C.kernel_facts(r)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
