"""The launch plans of the GroupNorm + swish backward (``ops/gn_swish_bwd.py
gn_bwd_plan``) and of the LayerNorm backward (``ops/layer_norm.py
ln_bwd_plan``), and torch models of both kernels' summation order.

On the CPU: the plans cover every row once, fit a block's shared memory and
the card's resident blocks; the models (the grid's partials in the
plan's order, ``ops/grid_sync.py:ordered_column_sum``) are held to the JAX
kernels run in interpret mode within the bars the card holds the kernels
to: dx atol = rtol 1e-2 in bf16 and 1e-4 in float32, dgamma and dbeta 1e-4
of their largest magnitude.  The order inside a block (threads' rows, then
warps) is not modelled: torch sums a chunk's rows.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops import gn_swish_bwd as jgn
from vqvae_from_gaussian_vae_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from vqvae_from_gaussian_vae_tpu.ops.layer_norm import layer_norm_add as jax_layer_norm_add
from vqvae_from_gaussian_vae_tpu_torch.ops import _build, grid_sync
from vqvae_from_gaussian_vae_tpu_torch.ops import gn_swish_bwd as gsb
from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln

DX_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
PARAM_REL = 1e-4

# (B, H, W, C) of the sd3unet ae step's four sites at bs=16, and the card
# tests' odd shapes
GN_SHAPES = [(16, 256, 256, 128), (16, 128, 128, 256), (16, 64, 64, 512), (16, 32, 32, 512),
             (1, 7, 9, 256), (2, 4, 4, 2048), (3, 32, 32, 512), (2, 16, 16, 64)]


def _gn_tasks(plan, b, hw):
    """(wave, block, sample, first row, end row) of every chunk a block
    owns, as the kernel's ``Task`` reads the plan."""
    for w in range(plan.waves):
        for j in range(plan.grid):
            s, q = w * plan.upw + j // plan.cpu, j % plan.cpu
            r0, r1 = q * plan.rows, min(q * plan.rows + plan.rows, hw)
            if j < plan.upw * plan.cpu and s < b and r0 < r1:
                yield w, j, s, r0, r1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_SHAPES + [(136, 4, 4, 64), (140, 3, 5, 128)])
def test_gn_bwd_plan_covers_every_row_once(shape, dtype):
    b, h, w, c = shape
    hw, esize = h * w, torch.empty((), dtype=dtype).element_size()
    plan = gsb.gn_bwd_plan(b, hw, c, 32, dtype)
    assert plan.smem == gsb.gn_smem(c, 32, esize) <= grid_sync.SMEM_BLOCK_MAX
    assert plan.grid <= grid_sync.SMS * grid_sync.blocks_per_sm(plan.smem, plan.threads)
    assert plan.grid == plan.upw * plan.cpu and plan.cpu == -(-hw // plan.rows)
    assert plan.waves == (1 if b <= grid_sync.SMS else -(-b // grid_sync.SMS))
    seen = np.zeros((b, hw), dtype=np.int32)
    for _, _, s, r0, r1 in _gn_tasks(plan, b, hw):
        seen[s, r0:r1] += 1
    assert (seen == 1).all()


def test_gn_bwd_plans_fit_every_width():
    """Every C the entry takes (a multiple of 8 up to MAX_C) fits a block's
    shared memory in either dtype, groups of one channel and more; the
    sd3unet sites run one wave on 128 of the card's 132 SMs."""
    for dtype in (torch.bfloat16, torch.float32):
        esize = torch.empty((), dtype=dtype).element_size()
        for c in range(8, gsb.MAX_C + 1, 8):
            for groups in (1, c):
                assert gsb.gn_smem(c, groups, esize) <= grid_sync.SMEM_BLOCK_MAX
    for b, h, w, c in GN_SHAPES[:4]:
        plan = gsb.gn_bwd_plan(b, h * w, c, 32, torch.bfloat16)
        assert (plan.waves, plan.grid, plan.cpu) == (1, 128, 8)


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", [(16384, 768), (13, 8), (77, 200), (3000, 4096)])
def test_ln_bwd_plan_covers_every_row_once(rows, c, dtype, add):
    esize = torch.empty((), dtype=dtype).element_size()
    plan = ln.ln_bwd_plan(rows, c, dtype, add=add)
    assert plan.smem == ln.ln_bwd_smem(c, esize, add, plan.rows, plan.stages)
    assert plan.smem <= grid_sync.SMEM_BLOCK_MAX and 2 <= plan.stages <= ln.LN_BWD_MAX_STAGES
    assert plan.grid <= grid_sync.SMS * grid_sync.blocks_per_sm(plan.smem, plan.threads)
    assert plan.threads == ln.ln_bwd_threads(c, dtype) and 1 <= plan.grid <= rows
    assert plan.rows * c * esize * (3 if add else 2) < 1 << 20  # one mbarrier phase's bytes
    seen = np.zeros(rows, dtype=np.int32)
    for j in range(plan.grid):
        seen[rows * j // plan.grid:rows * (j + 1) // plan.grid] += 1
    assert (seen == 1).all()
    if (rows, c, dtype) == (16384, 768, torch.bfloat16):  # the ViT rows: a slab row a warp
        assert plan.grid == grid_sync.SMS and plan.rows == plan.threads // 32 == 16


@pytest.mark.parametrize("parts,cols,threads", [(132, 16, 512), (8, 1536, 512), (2112, 2, 512),
                                                (7, 3, 256), (66, 64, 512)])
def test_ordered_column_sum_model(parts, cols, threads):
    """The runs cover every part once, a power of two of them; the model's
    sum is the float64 sum within float32 rounding."""
    runs = grid_sync.column_runs(parts, cols, threads)
    assert [p for p0, p1 in runs for p in range(p0, p1)] == list(range(parts))
    assert len(runs) & (len(runs) - 1) == 0 and len(runs) * cols <= max(threads, cols * 2)
    part = torch.from_numpy(np.random.default_rng(parts).standard_normal((parts, cols))
                            .astype(np.float32))
    got = grid_sync.ordered_column_sum(part, threads)
    np.testing.assert_allclose(got.numpy(), part.double().sum(0).numpy(), rtol=1e-5, atol=1e-4)


# --- torch models of the kernels' order, against the JAX kernels ------------

def gn_model(x, dy, mean_c, rstd_c, gamma, beta, groups, plan):
    """The GroupNorm + swish backward in the kernel's order: each chunk's
    per-channel sums and gamma-weighted group sums, a sample's constants
    summed over its chunks by ``ordered_column_sum``, dgamma and dbeta by
    each block's slice of the columns over (sample, chunk)."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // groups
    xs, dys = x.float().reshape(b, hw, c), dy.float().reshape(b, hw, c)
    g32, b32 = gamma.float(), beta.float()
    xhat = (xs - mean_c[:, None, :]) * rstd_c[:, None, :]
    hpre = xhat * g32 + b32
    sig = 1.0 / (1.0 + torch.exp(-hpre))
    dh = dys * (sig * (1.0 + hpre * (1.0 - sig)))
    inv_n = np.float32(1.0) / (np.float32(hw) * np.float32(cg))
    cpart = torch.zeros((b, plan.cpu, 2, c))
    dx = torch.empty((b, hw, c))
    for wave in range(plan.waves):
        gpart, samples = {}, {}
        for _, j, s, r0, r1 in (t for t in _gn_tasks(plan, b, hw) if t[0] == wave):
            q = j % plan.cpu
            blk = torch.cat([(dh * xhat)[s, r0:r1].sum(0), dh[s, r0:r1].sum(0)])
            cpart[s, q] = blk.reshape(2, c)
            grp = torch.zeros(2 * groups)
            for i in range(2 * groups):
                k, g0 = divmod(i, groups)
                for cc in range(cg):
                    grp[i] = grp[i] + g32[g0 * cg + cc] * blk[k * c + g0 * cg + cc]
            gpart[j] = grp
            samples[j - q] = s
        for first, s in samples.items():
            tot = grid_sync.ordered_column_sum(
                torch.stack([gpart[first + p] for p in range(plan.cpu)]), plan.threads)
            c1 = (tot[groups:] * inv_n).repeat_interleave(cg)
            c2 = (tot[:groups] * inv_n).repeat_interleave(cg)
            dx[s] = (dh[s] * g32 - c1 - xhat[s] * c2) * rstd_c[s]
    flat, dgb = cpart.reshape(b * plan.cpu, 2 * c), torch.zeros(2 * c)
    per = -(-2 * c // plan.grid)
    for j in range(plan.grid):
        col0, col1 = min(2 * c, j * per), min(2 * c, j * per + per)
        if col1 > col0:
            dgb[col0:col1] = grid_sync.ordered_column_sum(flat[:, col0:col1], plan.threads)
    return dx.to(x.dtype).reshape(x.shape), dgb[:c], dgb[c:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms,b", [(132, 2), (4, 6)])
def test_gn_model_of_the_kernel_order_matches_jax_kernel(dtype, sms, b):
    """A small shape on the card's plan (a row a chunk, 64 chunks a sample)
    and on a 4-SM plan with more samples than SMs (two waves, a chunk a
    sample)."""
    h, w, c = 8, 8, 64
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((b, h, w, c)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.3 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.2).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)

    def loss(x_, s_, b_):
        y = jgn.gn_swish(x_, s_, b_, 32, 1e-6, True)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(gamma), jnp.asarray(beta))
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    _, (mean_c, rstd_c) = gsb.gn_swish_ref(tx, tg, tb)
    plan = gsb.gn_bwd_plan(b, h * w, c, 32, dtype, sms=sms)
    assert plan.cpu > 1 or plan.waves > 1
    got = gn_model(tx, tdy, mean_c, rstd_c, tg, tb, 32, plan)
    tol = DX_TOL[dtype]
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], np.float32),
                               atol=tol, rtol=tol)
    for g, j in zip(got[1:], want[1:]):
        j = np.asarray(j, np.float32)
        assert np.abs(g.numpy() - j).max() <= PARAM_REL * np.abs(j).max()


def ln_model(x, weight, dy, plan, eps=1e-5, ds_in=None):
    """The LN backward in the kernel's order: each block's column partials
    over its rows in row order, then each block's slice of the columns over
    the grid's partials by ``ordered_column_sum``."""
    r, c = x.shape
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    wdy = dyf * weight.float()
    dx = (wdy - wdy.mean(-1, keepdim=True) - xhat * (wdy * xhat).mean(-1, keepdim=True)) * rstd
    if ds_in is not None:
        dx = dx + ds_in.float()
    part = torch.zeros((plan.grid, 2 * c))
    for j in range(plan.grid):
        acc_g, acc_b = torch.zeros(c), torch.zeros(c)
        for row in range(r * j // plan.grid, r * (j + 1) // plan.grid):
            acc_g = acc_g + dyf[row] * xhat[row]
            acc_b = acc_b + dyf[row]
        part[j] = torch.cat([acc_g, acc_b])
    dgb, per = torch.zeros(2 * c), -(-2 * c // plan.grid)
    for j in range(plan.grid):
        col0, col1 = min(2 * c, j * per), min(2 * c, j * per + per)
        if col1 > col0:
            dgb[col0:col1] = grid_sync.ordered_column_sum(part[:, col0:col1], plan.threads)
    return dx.to(x.dtype), dgb[:c], dgb[c:]


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_model_of_the_kernel_order_matches_jax_kernel(dtype, add):
    """(64, 256) rows over the plan a 3-SM card gives: three blocks."""
    rng = np.random.default_rng(17)
    x, d, dy, ds_in = (rng.standard_normal((64, 256)).astype(np.float32) for _ in range(4))
    x = x * 2 + 0.5
    g = (rng.standard_normal(256) * 0.3 + 1.0).astype(np.float32)
    b = (rng.standard_normal(256) * 0.1).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tx, td, tdy, tds = (torch.from_numpy(a).to(dtype) for a in (x, d, dy, ds_in))
    plan = ln.ln_bwd_plan(64, 256, dtype, add=add, sms=3)
    assert plan.grid == 3
    jargs = tuple(jnp.asarray(a, jdt) for a in (x, d, dy, ds_in))
    if add:
        _, vjp = jax.vjp(lambda x_, d_, g_, b_: jax_layer_norm_add(x_, d_, g_, b_, 1e-5, True),
                         jargs[0], jargs[1], jnp.asarray(g), jnp.asarray(b))
        want = vjp((jargs[3], jargs[2]))
        want = (want[0], want[2], want[3])
        s = (tx.float() + td.float()).to(dtype)
        got = ln_model(s, torch.from_numpy(g), tdy, plan, ds_in=tds)
    else:
        _, vjp = jax.vjp(lambda x_, g_, b_: jax_layer_norm(x_, g_, b_, 1e-5, True),
                         jargs[0], jnp.asarray(g), jnp.asarray(b))
        want = vjp(jargs[2])
        got = ln_model(tx, torch.from_numpy(g), tdy, plan)
    tol = DX_TOL[dtype]
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], np.float32),
                               atol=tol, rtol=tol)
    for p, j in zip(got[1:], want[1:]):
        j = np.asarray(j, np.float32)
        assert np.abs(p.numpy() - j).max() <= PARAM_REL * np.abs(j).max()


@pytest.mark.parametrize("entry,source", [("gvq_gn_swish_bwd", "gn_swish_bwd.cu"),
                                          ("gvq_layer_norm_bwd", "layer_norm.cu"),
                                          ("gvq_layer_norm_add_bwd", "layer_norm.cu")])
def test_ctypes_signatures_follow_the_c_entries(entry, source):
    """The ctypes table gives each entry as many arguments as its C
    prototype, a pointer for every pointer and the plan."""
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = _build._SIGNATURES[entry]
    assert len(argtypes) == len(params)
    for p, t in zip(params, argtypes):
        assert (t is _build._P) == ("*" in p), (p, t)
