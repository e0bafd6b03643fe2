"""B18 on the card: can a LayerNorm fused into the matmul's prologue beat the
LN kernel + library matmul pair?  At the bsqvit projections fed by a
LayerNorm: (16384, 768) @ (768, 2304) (``in_proj``) and 768 -> 3072
(``c_fc``), bf16.

The port of ``scripts/exp_ln_matmul.py`` (its ``run``):

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_ln_matmul              # defaults
    python -m vqvae_from_gaussian_vae_tpu_torch.labs.exp_ln_matmul fused:512:2304 xla

A combo is ``variant[:bm[:n]]`` (bm 512 and n 2304 by default), the JAX
lab's syntax:

  xla    the port's LN kernel (``ops/layer_norm.py``), then ``torch.matmul``
         (cuBLAS: JAX leaves this product to XLA), then the float32 bias
         add rounded to bf16 in one elementwise call: the shipped pair, two
         roundings; bm is not read
  pmm    the LN kernel, then ``matmul_bias_cuda`` (prices the hand matmul
         against cuBLAS)
  fused  ``ln_matmul_cuda``: one kernel, LN in the matmul's prologue

bm keeps the JAX lab's meaning, the rows that share one pass over W.  A
Hopper block cannot hold them at once as the TPU block does; the kernels
(``csrc/ln_matmul.cu``) walk 128 x 256 output tiles persistently, one
block an SM, and bm / 128 M tiles form a raster group whose column tiles
run together, sharing W's tiles through L2.  So every combo fills the card
whatever its bm.  The defaults are the JAX lab's seven and one of the
port's, ``fused:128:2304``, the raster of single M tiles.

Inputs are drawn as the JAX lab draws them (``default_rng(0)``: x, g, b, W,
wb).  A site feeds ``x + 1e-6 y[:, :768]`` to the next (one ``torch.add``,
as XLA fuses it), 12 sites a chain; each line reports microseconds per site
(the feedback included, as in the JAX lab; CUDA events, best of 3 trials of
10 chains after a warm-up), the bound, ``max_err`` against the JAX lab's
reference bf16(bf16(LN(x)) @ W + wb) in float32, the xla pair's time at the
same n, and the kernel's grid, tiles, registers and spills.  It runs on a
CUDA card only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vqvae_from_gaussian_vae_tpu_torch.labs import _common as C
from vqvae_from_gaussian_vae_tpu_torch.labs._timing import best_ms, time_ms
from vqvae_from_gaussian_vae_tpu_torch.ops import ln_matmul as LM

R, WIDTH = 16384, 768
EPS = LM.EPS
LAYERS = 12
VARIANTS = ("xla", "pmm", "fused")
JAX_DEFAULTS = [("xla", 512, 2304), ("pmm", 512, 2304), ("fused", 512, 2304),
                ("fused", 256, 2304), ("fused", 1024, 2304), ("xla", 512, 3072),
                ("fused", 512, 3072)]
PORT_COMBO = ("fused", 128, 2304)  # the port's own: raster groups of one M tile
DEFAULT_COMBOS = JAX_DEFAULTS + [PORT_COMBO]
REL_BAR = 1e-2  # max_err over max |reference|: one bf16 ulp at the largest output


def parse_combos(args):
    """``variant[:bm[:n]]`` arguments -> [(variant, bm, n)], refusing an
    unknown variant or a row block that is not compiled."""
    combos = []
    for a in args:
        parts = a.split(":")
        variant = parts[0]
        bm = int(parts[1]) if len(parts) > 1 else 512
        n = int(parts[2]) if len(parts) > 2 else 2304
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r} (one of {list(VARIANTS)})")
        if variant != "xla":
            LM.check_tiling(bm)
        combos.append((variant, bm, n))
    return combos


def lab_inputs(n: int, seed: int = 0, rows: int = R, width: int = WIDTH, device="cuda"):
    """(x, g, b, W, wb) drawn as the JAX lab's ``run`` draws them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, width))).to(device, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(width)).to(device, torch.float32)
    b = torch.from_numpy(rng.standard_normal(width)).to(device, torch.float32)
    w = torch.from_numpy(rng.standard_normal((width, n)) * 0.02).to(device, torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal(n) * 0.01).to(device, torch.float32)
    return x, g, b, w, wb


def plain_site(variant: str, x, g, b, w, wb):
    """One site's plain version: ``xla`` rounds the product and then the
    sum; ``pmm`` and ``fused`` compute one function, rounded once."""
    if variant == "xla":
        return LM.ln_matmul_xla_plain(x, g, b, w, wb, EPS)
    return LM.ln_matmul_plain(x, g, b, w, wb, EPS)


def make_site(variant: str, bm: int, g, b, w, wb):
    """One site of a variant on the card, x -> (R, n) bf16."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.layer_norm import layer_norm_cuda

    if variant == "xla":
        def site(x):
            mm = torch.matmul(layer_norm_cuda(x, g, b, EPS), w)
            out = torch.empty_like(mm)
            return torch.add(mm, wb, out=out)  # float32 sum, one rounding, one pass
    elif variant == "pmm":
        def site(x):
            return LM.matmul_bias_cuda(layer_norm_cuda(x, g, b, EPS), w, wb, bm)
    elif variant == "fused":
        def site(x):
            return LM.ln_matmul_cuda(x, g, b, w, wb, bm, EPS)
    else:
        raise ValueError(f"unknown variant {variant!r} (one of {list(VARIANTS)})")
    return site


def flops_bytes(variant: str, n: int, rows: int = R, width: int = WIDTH):
    """(FLOP, bytes) of one site's kernel: x (or y), W, wb (and g, b) read
    once, out written once."""
    nbytes = 2 * rows * width + 2 * width * n + 4 * n + 2 * rows * n
    return 2.0 * rows * width * n, nbytes + (0 if variant == "pmm" else 8 * width)


def run(variant: str, bm: int, n: int, inputs=None, ref=None, layers: int = LAYERS) -> dict:
    """Time one combo and check it; returns its report, ``out`` being the
    output of the checked site."""
    C.require_card()
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {list(VARIANTS)})")
    if variant != "xla":
        LM.check_tiling(bm)
    x, g, b, w, wb = inputs if inputs is not None else lab_inputs(n)
    # the JAX lab's max_err reference, bf16(bf16(LN(x)) @ W + wb) in float32
    ref = ref if ref is not None else LM.ln_matmul_plain(x, g, b, w, wb, EPS)
    site = make_site(variant, bm, g, b, w, wb)
    width = x.shape[1]
    torch.cuda.reset_peak_memory_stats()

    def chain():
        xi = x
        for _ in range(layers):
            xi = torch.add(xi, site(xi)[:, :width], alpha=1e-6)
        return xi

    us = 1e3 * best_ms(chain) / layers
    out = site(x)
    bound, by = C.bound_ms(*flops_bytes(variant, n, x.shape[0], width))
    report = {"lab": "exp_ln_matmul", "combo": f"{variant}:{bm}:{n}", "us_per_site": us,
              "bound_us": 1e3 * bound, "bound_by": by, "max_err": C.max_abs(out, ref),
              "ref_max": float(ref.float().abs().max()), "checked": True,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "out": out}
    if variant != "xla":
        plan = LM.ln_matmul_plan(x.shape[0], width, n, bm,
                                 torch.cuda.get_device_properties(x.device).multi_processor_count)
        report.update(blocks=plan.grid, tiles=plan.tiles, raster_group=plan.group,
                      tile=f"{LM.TILE_M}x{LM.TILE_N}x{LM.TILE_K}", stages=LM.STAGES,
                      smem_bytes=plan.smem,
                      ptxas=LM.ptxas_of(C.ptxas_usage(), variant == "fused"))
    return report


def main(argv=None) -> int:
    combos = parse_combos(sys.argv[1:] if argv is None else argv) or DEFAULT_COMBOS
    C.require_card()
    state = {}
    for n in sorted({n for _, _, n in combos}):
        inputs = lab_inputs(n)
        xla = make_site("xla", 0, *inputs[1:])
        state[n] = (inputs, LM.ln_matmul_plain(*inputs, EPS),
                    1e3 * time_ms(lambda xla=xla, x=inputs[0]: xla(x)))
    print(f"# {torch.cuda.get_device_name(0)}; xla pair (LN kernel + torch.matmul + bias) "
          + ", ".join(f"n={n}: {s[2]:.1f} us" for n, s in state.items()), flush=True)
    for variant, bm, n in combos:
        inputs, ref, xla_us = state[n]
        r = run(variant, bm, n, inputs, ref)
        regs = r.get("ptxas", {})
        print(f"{variant:8s} bm={bm:4d} n={n:4d}: {r['us_per_site']:8.1f} us/site  "
              f"max_err {r['max_err']:.3e} (max |ref| {r['ref_max']:.3g})  "
              f"bound {r['bound_us']:.1f} us  xla pair {xla_us:.1f} us"
              + (f"  blocks {r['blocks']}  regs {regs.get('registers')} spills "
                 f"{regs.get('spill_stores')}/{regs.get('spill_loads')}" if "blocks" in r else ""),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
