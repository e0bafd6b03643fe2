"""The LayerNorm-prologue matmul's launch plan (``ops/ln_matmul.py:ln_matmul_plan``,
``csrc/ln_matmul.cu``), on the CPU.

The plan's tiling against the C source's constants; every default combo of
the lab filling the card's 132 SMs whatever its row block (bm sets the
raster, not the grid), within a block's shared memory; the raster visiting
every output tile once, a group's column tiles together; the refusals; and
a torch model of the kernel's arithmetic (the statistics pass, each A tile
normalised on its own, 128 x 256 tiles in raster order walked by
persistent blocks, the float32 bias, one rounding) against the plain
version and the JAX lab's ``_pallas_fused`` under
``pltpu.force_tpu_interpret_mode()`` (the script imported by path and not
changed).  Bar: 1e-2 of max |reference|, one bf16 ulp at the largest output.
"""

import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu_torch.labs import exp_ln_matmul as lab
from vqvae_from_gaussian_vae_tpu_torch.ops import ln_matmul as LM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "vqvae_from_gaussian_vae_tpu_torch", "csrc", "ln_matmul.cu")
SCRIPT = os.path.join(ROOT, "scripts", "exp_ln_matmul.py")
REL = 1e-2


def _constants() -> dict:
    text = open(SOURCE).read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_plan_tiling_is_the_kernels():
    k = _constants()
    assert (k["kBM"], k["kBN"], k["kBK"], k["kStages"], k["kMaxC"]) == \
        (LM.TILE_M, LM.TILE_N, LM.TILE_K, LM.STAGES, LM.MAX_C)
    # a K step is one 128-byte swizzled row of bf16; two warpgroups own 64
    # rows each, beside a producer warpgroup
    assert LM.TILE_K * 2 == 128 and LM.TILE_M == 2 * 64 and k["kThreads"] == 3 * 128
    # the ring (x tile + four W boxes a stage), the staged half output tile,
    # barriers, slack, within the 232,448 bytes a block may have
    assert LM.smem_bytes() == 4 * (16_384 + 32_768) + 32_768 + 64 + 1024 <= 232_448


@pytest.mark.parametrize("variant,bm,n", lab.DEFAULT_COMBOS)
def test_every_lab_combo_fills_the_card(variant, bm, n):
    plan = LM.ln_matmul_plan(lab.R, lab.WIDTH, n, bm)
    assert plan.grid == 132 and plan.tiles == 128 * (n // 256)
    assert plan.group == bm // 128 and plan.k_steps == 12
    # each block walks its share of the tiles, none more than one tile past another
    per_block = [len(range(blk, plan.tiles, plan.grid)) for blk in range(plan.grid)]
    assert max(per_block) - min(per_block) <= 1 and sum(per_block) == plan.tiles


@pytest.mark.parametrize("r,n,bm", [(16384, 2304, 128), (16384, 3072, 512),
                                    (16384, 2304, 1024), (777, 264, 384), (130, 8, 128),
                                    (5000, 776, 640)])
def test_raster_visits_every_tile_once_and_runs_a_groups_columns_together(r, n, bm):
    plan = LM.ln_matmul_plan(r, 96, n, bm)
    seen = [LM.tile_coords(plan, t) for t in range(plan.tiles)]
    assert sorted(seen) == [(m, c) for m in range(plan.m_tiles) for c in range(plan.n_tiles)]
    # within a raster group, the group's M tiles take one column tile after another
    for t in range(plan.tiles - 1):
        (m0, c0), (m1, c1) = seen[t], seen[t + 1]
        if m0 // plan.group == m1 // plan.group:
            first = m0 // plan.group * plan.group
            assert (c1 == c0 and m1 == m0 + 1) or (c1 == c0 + 1 and m1 == first)
    assert plan.grid == min(plan.tiles, 132)


@pytest.mark.parametrize("r,c,n,bm", [(256, 800, 256, 128), (256, 48, 256, 128),
                                      (256, 768, 12, 128), (256, 768, 256, 64),
                                      (256, 768, 256, 192), (256, 768, 256, 0),
                                      (0, 768, 256, 128)])
def test_unsupported_shapes_and_row_blocks_raise(r, c, n, bm):
    with pytest.raises(ValueError, match="unsupported|not compiled"):
        LM.ln_matmul_plan(r, c, n, bm)


def _kernel_model(x, g, b, w, wb, bm, ln=True):
    """The kernel's arithmetic in torch: row statistics first (float32, two
    passes), each 64-channel A tile normalised on its own and rounded to
    bf16 (0 past C), the products of bf16 values summed in float32 a tile at
    a time, + the float32 bias, one rounding; tiles in raster order, dealt to
    persistent blocks."""
    r, c = x.shape
    n = w.shape[1]
    plan = LM.ln_matmul_plan(r, c, n, bm)
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(dim=1, keepdim=True) + LM.EPS)
    out = torch.full((r, n), float("nan"))
    for blk in range(plan.grid):
        for t in range(blk, plan.tiles, plan.grid):
            mt, nt = LM.tile_coords(plan, t)
            rows = slice(mt * LM.TILE_M, min(r, (mt + 1) * LM.TILE_M))
            cols = slice(nt * LM.TILE_N, min(n, (nt + 1) * LM.TILE_N))
            acc = torch.zeros((rows.stop - rows.start, cols.stop - cols.start))
            for kb in range(plan.k_steps):
                ch = slice(kb * LM.TILE_K, min(c, (kb + 1) * LM.TILE_K))
                a = xf[rows, ch]
                if ln:
                    a = ((a - mean[rows]) * rstd[rows] * g[ch] + b[ch]).to(torch.bfloat16)
                acc += a.float() @ w[ch, cols].float()
            assert bool(out[rows, cols].isnan().all())  # each tile once
            out[rows, cols] = acc + wb[cols]
    return out.to(torch.bfloat16)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("r,c,n,bm", [(300, 96, 264, 256), (512, 128, 200, 256)])
def test_kernel_model_matches_the_plain_versions(r, c, n, bm):
    x, g, b, w, wb = lab.lab_inputs(n, rows=r, width=c, device="cpu")
    assert _rel(_kernel_model(x, g, b, w, wb, bm), LM.ln_matmul_plain(x, g, b, w, wb)) <= REL
    assert _rel(_kernel_model(x, g, b, w, wb, bm, ln=False),
                LM.matmul_bias_plain(x, w, wb)) <= REL


def test_kernel_model_matches_the_jax_fused_kernel():
    spec = importlib.util.spec_from_file_location("jax_lab_exp_ln_matmul_plan", SCRIPT)
    jax_lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_lab)
    r, c, n, bm = 512, 128, 200, 256
    x, g, b, w, wb = lab.lab_inputs(n, rows=r, width=c, device="cpu")

    def j(t, dtype=jnp.float32):
        return jnp.asarray(t.float().numpy(), dtype)

    with pltpu.force_tpu_interpret_mode():
        want = jax_lab._pallas_fused(j(x, jnp.bfloat16), j(g), j(b), j(w, jnp.bfloat16), j(wb),
                                     bm)
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert _rel(_kernel_model(x, g, b, w, wb, bm), want) <= REL
