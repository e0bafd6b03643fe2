"""B15 on the card: the flash forward under other softmax policies and K/V
stage depths, at the bsqvit shape (B=16, L=1024, H=12, D=64) bf16.

The port of ``scripts/exp_flash_variants.py`` (its kernel ``make_kernel``):

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_variants base:1 matonly:1 ...

A combo is ``policy:depth``.  Policies, each a template value of the
forward body (``csrc/flash_fwd.cuh``), at the shipped tiling (32 q rows,
64-key tiles, 8 warps, one head a block):

  base      the shipped online softmax: per-row max, then exp
  nomax     p = exp(min(s, 30) - 30): no max pass, no rescale
  exp2      exp2f((s - m) log2 e), log2 e folded into the scale
  tilemax   one max per (q tile x key tile), a scalar rescale
  matonly   p = bf16(s): no softmax; the control (its rows divide by a row
            sum of raw scores, so its output is timed, not checked)
  chunk     nomax's function on the two 32-key halves of each tile, each
            half's score product and exp on its own half of the warps
  sbf16     the score tile rounded to bf16, then (s - m) in bf16

What they mean on Hopper.  On the TPU ``sbf16`` was illegal (Mosaic needs
a 32-bit matmul accumulator) and ``chunk`` crashed the worker; here both
run.  ``sbf16`` prices halving the bytes the softmax pass reads from
shared memory (bf16 scores instead of the float32 ``Ss`` tile of
``FlashLayout``); wmma stores float accumulators only, so each warp rounds
its fragment into the bf16 tile after storing it.  ``chunk``'s TPU point
(interleaving MXU and VPU work inside a head) has no direct counterpart,
since the port already walks L in 64-key tiles: this is its function,
with each warp half's exp free to run beside the other half's tensor-core
work, timed as it is.

Depth: on the TPU the head-pipeline depth bought MXU/VPU overlap across
heads.  On Hopper the overlap to buy is load latency against tensor-core
work, so depth is the K/V stage depth: 1, one K-or-V buffer as the shipped
kernel runs; 2, ``cp.async`` copies of the next K or V tile into a second
buffer while the current tile's product runs.

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
    return {"lab": "exp_flash_variants", "combo": f"{variant}:{depth}", "us_per_layer": us,
            "bound_us": 1e3 * bound, "bound_by": by, "max_err": C.max_abs(out, ref),
            "checked": variant != "matonly",
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "ptxas": FL.ptxas_of(usage, "flash_fwd_kernel",
                                 FL.fwd_kernel_args(variant, depth, *FL.VARIANT_TILING)),
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
              f"SDPA {sdpa_us:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
