"""The port's flash labs (``ops/flash_lab.py``, ``labs/``) against the JAX
labs of ``scripts/`` (exp_flash_variants, exp_flash_fwd_tilings,
exp_flash_bwd_variants).

The JAX labs run their Pallas bodies only on a TPU, so here each body runs
in a test-side ``pl.pallas_call(..., interpret=True)`` with its script's
grid spec at a small shape (B=1, L=256, H=2, D=64), and the port's plain
versions, which the kernels are held to on the card, are held to it.  The
scripts are imported by path and not changed.  Bars: the JAX package's
bf16 attention bar, 2e-2 absolute on forward outputs and 2e-2 of max |grad|
on gradients; the no-softmax control 2e-2 of max |out|.  Also the labs'
command lines, their refusals, and that ``labs`` imports no JAX.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops import flash_blc as F
from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_bwd_variants as lab_bwd
from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_fwd_tilings as lab_tilings
from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_variants as lab_variants
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, H, D = 1, 256, 2, 64
C = H * D
SCALE = D ** -0.5
ATOL = 2e-2
REL = 2e-2


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_lab_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    """q, k, v, do: float32 draws rounded to bf16, as jax and torch arrays."""
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal((B, L, C)).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return jx, tx


def _to_torch(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _maps():
    def q_map(bi, gi, qi):
        return (bi, qi, gi)

    def kv_map(bi, gi, qi):
        del qi
        return (bi, 0, gi)

    return q_map, kv_map


def _fwd_call(body, hpb, block_q):
    """The forward labs' ``pallas_call``: grid (B, H / hpb, L / block_q)."""
    cg = hpb * D
    q_map, kv_map = _maps()
    return pl.pallas_call(
        body,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(B, H // hpb, L // block_q),
            in_specs=[pl.BlockSpec((1, block_q, cg), q_map), pl.BlockSpec((1, L, cg), kv_map),
                      pl.BlockSpec((1, L, cg), kv_map)],
            out_specs=pl.BlockSpec((1, block_q, cg), q_map)),
        out_shape=jax.ShapeDtypeStruct((B, L, C), jnp.bfloat16),
        interpret=True)


VARIANTS = [("base", 1), ("base", 2), ("nomax", 1), ("exp2", 1), ("tilemax", 1), ("chunk", 1),
            ("sbf16", 1)]


@pytest.mark.parametrize("variant,depth", VARIANTS)
def test_variant_plain_matches_the_jax_lab(inputs, monkeypatch, variant, depth):
    """exp_flash_variants.make_kernel (its BQ, all heads a block) against
    ``flash_variant_plain``; ``matonly`` is a control and is not held."""
    mod = _script("exp_flash_variants")
    monkeypatch.setattr(mod, "H", H)
    (jq, jk, jv, _), (tq, tk, tv, _) = inputs
    got = _fwd_call(mod.make_kernel(variant, depth), H, min(mod.BQ, L))(jq, jk, jv)
    want = FL.flash_variant_plain(tq, tk, tv, variant, SCALE, H)
    assert want.dtype == torch.bfloat16 and want.shape == tq.shape
    assert float((_to_torch(got) - want.float()).abs().max()) <= ATOL


@pytest.mark.parametrize("hpb,block_q", [(1, 128), (2, 128), (2, 256)])
def test_fwd_tiling_plain_matches_the_jax_lab(inputs, hpb, block_q):
    """exp_flash_fwd_tilings' body (flash_blc._fwd_kernel) at explicit
    tilings against the base variant's plain version."""
    (jq, jk, jv, _), (tq, tk, tv, _) = inputs
    body = functools.partial(F._fwd_kernel, sm_scale=SCALE, heads=hpb)
    got = _fwd_call(body, hpb, block_q)(jq, jk, jv)
    want = FL.flash_variant_plain(tq, tk, tv, "base", SCALE, H)
    assert float((_to_torch(got) - want.float()).abs().max()) <= ATOL


def _bwd_call(body, hpb, block_q, fwd_hpb):
    """exp_flash_bwd_variants.run's ``pallas_call``."""
    cg = hpb * D
    q_map, kv_map = _maps()
    q_spec = pl.BlockSpec((1, block_q, cg), q_map)
    kv_spec = pl.BlockSpec((1, L, cg), kv_map)
    z_spec = pl.BlockSpec((1, block_q, 128 * (H // fwd_hpb)), lambda bi, gi, qi: (bi, qi, 0))
    return pl.pallas_call(
        body,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(B, H // hpb, L // block_q),
            in_specs=[q_spec, kv_spec, kv_spec, q_spec, z_spec, q_spec],
            out_specs=[q_spec, kv_spec, kv_spec],
            scratch_shapes=[pltpu.VMEM((L, cg), jnp.float32), pltpu.VMEM((L, cg), jnp.float32)]),
        out_shape=[jax.ShapeDtypeStruct((B, L, C), jnp.bfloat16)] * 3,
        interpret=True)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("hpb,block_q,pipe", [(2, 128, 2), (1, 128, 1), (2, 256, 2)])
def test_bwd_tiling_plain_matches_the_jax_lab(inputs, hpb, block_q, pipe):
    """flash_blc._bwd_kernel at explicit (hpb, block_q, pipe), its z from
    the JAX training forward, against the port's plain backward fed the
    port's plain forward."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = inputs
    fwd_hpb = F._fwd_hpb(L, H, D, 2)
    o, z = F._fwd_res_call(jq, jk, jv, SCALE, H, True)
    body = functools.partial(F._bwd_kernel, sm_scale=SCALE, heads=hpb,
                             num_q_blocks=L // block_q, num_groups=H // hpb, fwd_hpb=fwd_hpb,
                             pipe_depth=pipe)
    got = _bwd_call(body, hpb, block_q, fwd_hpb)(jq, jk, jv, o, z, jdo)
    to, tz = fa.flash_attention_res_plain(tq, tk, tv, SCALE, H)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, to, tz, tdo, SCALE, H)
    for g, w in zip(got, want):
        assert _rel(_to_torch(g), w) <= REL


def test_bwd_control_plain_matches_the_jax_lab(inputs):
    """exp_flash_bwd_variants._control_kernel against
    ``flash_bwd_control_plain``."""
    mod = _script("exp_flash_bwd_variants")
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = inputs
    fwd_hpb = F._fwd_hpb(L, H, D, 2)
    o, z = F._fwd_res_call(jq, jk, jv, SCALE, H, True)
    body = functools.partial(mod._control_kernel, sm_scale=SCALE, heads=2, num_q_blocks=2,
                             pipe_depth=2)
    got = _bwd_call(body, 2, 128, fwd_hpb)(jq, jk, jv, o, z, jdo)
    want = FL.flash_bwd_control_plain(tq, tk, tv, tdo, H)
    for g, w in zip(got, want):
        assert _rel(_to_torch(g), w) <= REL


def test_command_lines_parse_the_jax_syntax():
    assert lab_variants.parse_combos(["base:1", "matonly:1", "sbf16:1", "base:2"]) == \
        [("base", 1), ("matonly", 1), ("sbf16", 1), ("base", 2)]
    # hpb:block_q (keys by default) and hpb:rows:keys; 512 rows cannot fit and
    # stay listed, for run() to report why
    assert lab_tilings.parse_combos(["12:256", "1:192:128", "4:512"]) == \
        [(12, 256, 64), (1, 192, 128), (4, 512, 64)]
    assert lab_bwd.parse_combos(["128:64:2", "128:32:4", "128:64:3:control"]) == \
        [(128, 64, 2, False), (128, 32, 4, False), (128, 64, 3, True)]
    # every default combo is compiled
    assert lab_variants.parse_combos([f"{v}:{p}" for v, p in lab_variants.DEFAULT_COMBOS])
    for rows, tile, stages, control in lab_bwd.DEFAULT_COMBOS:
        FL.check_bwd_tiling(rows, tile, stages, control)
    for t in lab_tilings.default_combos():
        if lab_tilings.no_counterpart(*t) is None:
            FL.check_fwd_tiling(*t)


@pytest.mark.parametrize("lab,arg", [(lab_variants, "base:3"), (lab_variants, "softmax:1"),
                                     (lab_tilings, "4:128"), (lab_tilings, "3:256:64"),
                                     (lab_bwd, "128:32:2"), (lab_bwd, "128:32:3:control")])
def test_command_lines_refuse_uncompiled_combos_by_name(lab, arg):
    with pytest.raises(ValueError, match="compiled ones are"):
        lab.parse_combos([arg])


def test_jax_defaults_have_a_counterpart_or_a_reason():
    """B16's 512-row tilings are reported with the threads they would need
    (eight consumer warpgroups and the producer's); every B17 JAX default
    has a counterpart on the shipped backward body or a reason in its
    terms; the compiled combinations fit."""
    for hpb, rows in lab_tilings.JAX_DEFAULTS:
        keys = lab_tilings.default_keys(rows)
        if rows > 256:
            r = lab_tilings.run(hpb, rows, keys)
            assert "1152 threads" in r["skipped"]
        else:
            FL.check_fwd_tiling(hpb, rows, keys)
    lines = lab_bwd.jax_default_reasons()
    assert len(lines) == len(lab_bwd.JAX_DEFAULTS)
    assert all(("counterpart 128:64:" in s) == (" bq=128 " in s) for s in lines)
    assert all("no counterpart" in s for s in lines if " bq=128 " not in s)
    for hpb, rows, keys in FL.FWD_TILINGS:
        assert FL.fwd_smem_bytes(hpb, rows, keys) <= FL.SMEM_LIMIT and 12 % hpb == 0
    for policy, depth in FL.VARIANT_COMBOS:
        assert FL.fwd_smem_bytes(*FL.variant_tiling(policy, depth), policy) <= FL.SMEM_LIMIT
    for rows, tile, stages in FL.BWD_TILINGS + FL.BWD_CONTROLS:
        assert max(FL.bwd_smem_bytes(tile, stages)) <= FL.SMEM_LIMIT


def test_ptxas_report_is_matched_to_a_combination():
    fwd = ("_ZN12_GLOBAL__N_120flash_lab_fwd_kernelILb0ELi4ELi64ELi12ELi0ELi1EEEv14CUtensorMap_st"
           "S1_S1_NS_6F9ArgsE")
    bwd = ("_ZN12_GLOBAL__N_121flash_lab_dkdv_kernelILb0ELi64ELi3ELb1EEEv14CUtensorMap_stS1_S1_"
           "S1_NS_6B9ArgsE")
    usage = {fwd: {"registers": 96}, bwd: {"registers": 168}}
    assert FL.ptxas_of(usage, FL.FWD_KERNEL,
                       FL.fwd_kernel_args("base", 1, 12, 256, 64)) == {"registers": 96}
    assert FL.ptxas_of(usage, FL.FWD_KERNEL, FL.fwd_kernel_args("base", 1, 1, 192, 128)) == {}
    assert FL.ptxas_of(usage, FL.BWD_KERNELS[0],
                       FL.bwd_kernel_args(64, 3, True)) == {"registers": 168}
    assert FL.ptxas_of(usage, FL.BWD_KERNELS[1], FL.bwd_kernel_args(64, 3, True)) == {}


def test_kernel_wrappers_refuse_cpu_tensors_and_the_labs_need_a_card(inputs):
    tq, tk, tv, tdo = inputs[1]
    z = torch.zeros((B, H, L))
    with pytest.raises(ValueError):
        FL.flash_variant_cuda(tq, tk, tv, "base", 1, SCALE, H)
    with pytest.raises(ValueError):
        FL.flash_fwd_tiling_cuda(tq, tk, tv, 1, 192, 128, SCALE, H)
    with pytest.raises(ValueError):
        FL.flash_bwd_tiling_cuda(tq, tk, tv, tq, z, tdo, 128, 64, 3, SCALE, H)
    with pytest.raises(ValueError):
        FL.flash_bwd_control_cuda(tq, tk, tv, tdo, 128, 64, 3, H)
    assert (FL.flash_variant_cuda.launches, FL.flash_fwd_tiling_cuda.launches,
            FL.flash_bwd_tiling_cuda.launches, FL.flash_bwd_control_cuda.launches) == (0, 0, 0, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            lab_variants.run("base", 1)


def test_labs_import_no_jax():
    code = ("import sys\n"
            "import vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_variants\n"
            "import vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_fwd_tilings\n"
            "import vqvae_from_gaussian_vae_tpu_torch.labs.exp_flash_bwd_variants\n"
            "import vqvae_from_gaussian_vae_tpu_torch.labs.exp_ln_matmul\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vqvae_from_gaussian_vae_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
