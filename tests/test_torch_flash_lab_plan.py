"""The flash labs' launches on the shipped bodies (``ops/flash_lab.py``
over ``csrc/flash_fwd_sm90.cuh`` and ``csrc/flash_bwd_sm90.cuh``), on the
CPU: every compiled combination fits an H100 (threads, registers after
setmaxnreg, shared memory) and matches the C side's constants and lists;
the reference rows' plans are the shipped entries' plans; every JAX
default that has no counterpart says why with its number; and the plain
versions of ``tilemax`` and ``chunk`` at the kernels' row and key tiles
agree with the JAX lab's bodies in interpret mode.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_bwd_variants as lab_bwd
from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_fwd_tilings as lab_tilings
from vqvae_from_gaussian_vae_tpu_torch.ops import _build
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "vqvae_from_gaussian_vae_tpu_torch", "csrc")
D = 64
ATOL = 2e-2


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def fwd_header():
    return _source("flash_fwd_sm90.cuh")


@pytest.fixture(scope="module")
def bwd_header():
    return _source("flash_bwd_sm90.cuh")


def _variant_tilings():
    return sorted({(*FL.variant_tiling(p, d), p) for p, d in FL.VARIANT_COMBOS}
                  | {(*t, "base") for t in FL.FWD_TILINGS})


@pytest.mark.parametrize("hpb,rows,keys,policy", _variant_tilings())
def test_forward_combinations_fit_the_card(hpb, rows, keys, policy):
    lay = FL.fwd_layout(hpb, rows, keys, policy)
    assert lay["warpgroups"] * 64 == rows and lay["threads"] <= FL.MAX_THREADS
    # after setmaxnreg the consumers hold no more than the block launched
    # with (65,536 / threads a thread, in 8s) less the producer's share;
    # setmaxnreg takes 24..256 in 8s
    launch, most = FL.setmaxnreg_split(lay["warpgroups"], lay["producer_regs"])
    assert lay["consumer_regs"] == most and launch == FL.REGISTER_FILE // lay["threads"] // 8 * 8
    assert (128 * lay["warpgroups"] * lay["consumer_regs"] + 128 * lay["producer_regs"]
            <= launch * lay["threads"])
    regs = [lay["consumer_regs"], lay["producer_regs"]]
    assert all(24 <= r <= 256 and r % 8 == 0 for r in regs)
    assert lay["smem"] <= FL.SMEM_LIMIT and 12 % hpb == 0  # the labs' H
    # the score tile, O and the P fragments fit a consumer thread's registers
    # (two score tiles at depth 2)
    depth = 2 if (hpb, rows, keys) == FL.DEEP_TILING and policy == "base" else 1
    assert depth * keys // 2 + D // 2 + keys // 4 < lay["consumer_regs"]


@pytest.mark.parametrize("rows,tile,stages", FL.BWD_TILINGS + FL.BWD_CONTROLS)
def test_backward_combinations_fit_the_card(rows, tile, stages):
    kv, q = FL.bwd_smem_bytes(tile, stages)
    assert rows == FL.BWD_ROWS and max(kv, q) <= FL.SMEM_LIMIT
    assert FL.setmaxnreg_split(2, FL.BWD_PRODUCER_REGS)[1] == FL.BWD_CONSUMER_REGS
    assert lab_bwd.live_registers(tile) < FL.BWD_CONSUMER_REGS


def test_forward_constants_match_the_header(fwd_header):
    for name, value in FL.POLICIES.items():
        c = {"base": "kF9Base", "nomax": "kF9NoMax", "exp2": "kF9Exp2", "tilemax": "kF9TileMax",
             "matonly": "kF9MatOnly", "chunk": "kF9Chunk", "sbf16": "kF9Sbf16"}[name]
        assert re.search(rf"constexpr int {c} = {value};", fwd_header), c
    body = re.search(r"f9_consumer_regs\(int wg\) \{\s*return ([^;]+);", fwd_header).group(1)
    nums = [int(x) for x in re.findall(r"\d+", body)]
    assert nums == [2, FL.FWD_CONSUMER_REGS[2], 3, FL.FWD_CONSUMER_REGS[3],
                    FL.FWD_CONSUMER_REGS[4]]
    body = re.search(r"f9_producer_regs\(int wg\) \{ return ([^;]+);", fwd_header).group(1)
    assert [int(x) for x in re.findall(r"\d+", body)] == [2, FL.FWD_PRODUCER_REGS[2],
                                                          FL.FWD_PRODUCER_REGS[3]]
    assert FL.FWD_PRODUCER_REGS[4] == FL.FWD_PRODUCER_REGS[3]
    assert f"constexpr int kF9Stages = {FL.FWD_STAGES};" in fwd_header


def test_backward_constants_match_the_header(bwd_header):
    assert f"constexpr int kB9Rows = {FL.BWD_ROWS};" in bwd_header
    assert f"constexpr int kB9Threads = {FL.BWD_THREADS};" in bwd_header
    assert (f"constexpr int kB9ProducerRegs = {FL.BWD_PRODUCER_REGS}, "
            f"kB9ConsumerRegs = {FL.BWD_CONSUMER_REGS};") in bwd_header


def test_compiled_lists_match_the_entries():
    names = {"kF9" + k: v for k, v in [("Base", "base"), ("NoMax", "nomax"), ("Exp2", "exp2"),
                                       ("TileMax", "tilemax"), ("MatOnly", "matonly"),
                                       ("Chunk", "chunk"), ("Sbf16", "sbf16")]}
    fwd = re.findall(r"^\s*GVQ_LAB_FWD\((\w+), (\d+), (\d+), (\d+), (\d+)\)",
                     _source("flash_lab_fwd.cu"), re.M)
    compiled = {(names[p], int(dep), int(hp), int(r), int(k)) for p, dep, hp, r, k in fwd}
    want = {(p, dep, *FL.variant_tiling(p, dep)) for p, dep in FL.VARIANT_COMBOS}
    want |= {("base", 1, *t) for t in FL.FWD_TILINGS}
    assert compiled == want and len(fwd) == len(want)
    bwd = re.findall(r"^\s*GVQ_LAB_BWD\((\d+), (\d+), (true|false)\)",
                     _source("flash_lab_bwd.cu"), re.M)
    got = {(FL.BWD_ROWS, int(t), int(s), c == "true") for t, s, c in bwd}
    assert got == ({(*t, False) for t in FL.BWD_TILINGS}
                   | {(*t, True) for t in FL.BWD_CONTROLS})


@pytest.mark.parametrize("b,h,l", [(16, 12, 1024), (2, 12, 256), (2, 12, 200)])
def test_reference_rows_launch_as_the_shipped_entries(b, h, l):
    """The labs' reference rows are the shipped token-major entries' plans
    (``flash_fwd_plan``, ``flash_bwd_plan``), so the labs time that body."""
    c = h * D
    assert FL.lab_fwd_plan(b, h, l, *FL.VARIANT_TILING) == fa.flash_fwd_plan(
        "token_major", b, h, l, l, D, c)
    assert FL.lab_bwd_plan(b, h, l, 64, 3) == fa.flash_bwd_plan("token_major", b, h, l, l, D, c)


@pytest.mark.parametrize("hpb,rows,keys", FL.FWD_TILINGS)
@pytest.mark.parametrize("l", [1024, 200])
def test_forward_plans_cover_every_row_and_head(hpb, rows, keys, l):
    b, h = 2, 12
    plan = FL.lab_fwd_plan(b, h, l, hpb, rows, keys)
    assert plan.grid == (-(-l // rows), b * h // hpb) and plan.key_mask == (l % keys != 0)
    assert plan.smem == FL.fwd_smem_bytes(hpb, rows, keys)
    assert [m.box[2] for m in plan.maps] == [rows, keys, keys]
    # each block's heads: blockIdx.y * hpb .. + hpb - 1, all of one batch row
    heads = [[y * hpb + i for i in range(hpb)] for y in range(plan.grid[1])]
    assert sorted(sum(heads, [])) == list(range(b * h))
    assert all(len({x // h for x in hs}) == 1 for hs in heads)


@pytest.mark.parametrize("rows,tile,stages", FL.BWD_TILINGS)
def test_backward_plans_use_the_tilings(rows, tile, stages):
    plan = FL.lab_bwd_plan(2, 12, 200, tile, stages)
    assert (plan.kv_rows, plan.kv_q_rows, plan.q_rows, plan.q_k_rows, plan.stages) == \
        (rows, tile, rows, 2 * tile, stages)
    assert [m.box[2] for m in plan.maps] == [tile, 2 * tile, 2 * tile, tile]
    assert (plan.kv_smem, plan.q_smem) == FL.bwd_smem_bytes(tile, stages)
    assert plan.q_mask == (200 % tile != 0) and plan.key_mask == (200 % (2 * tile) != 0)


def test_jax_defaults_name_their_numbers():
    """Each forward tiling without a counterpart names its threads; each
    backward default names its counterpart or the threads or registers that
    rule it out."""
    for hpb, rows in lab_tilings.JAX_DEFAULTS:
        keys = lab_tilings.default_keys(rows)
        reason = lab_tilings.no_counterpart(hpb, rows, keys)
        if rows > 256:
            assert f"{FL.fwd_layout(hpb, rows, keys)['threads']} threads" in reason
            assert str(FL.MAX_THREADS) in reason
        else:
            assert reason is None
    for (hpb, bq, pipe), line in zip(lab_bwd.JAX_DEFAULTS, lab_bwd.jax_default_reasons()):
        twin = lab_bwd.jax_default_counterpart(hpb, bq, pipe)
        if twin is not None:
            assert "counterpart {}:{}:{}".format(*twin) in line
        elif bq == 512:
            assert "1152 threads" in line and str(FL.MAX_THREADS) in line
        else:
            assert f"{FL.setmaxnreg_split(bq // 64, 24)[1]} registers" in line
            assert f"against the {lab_bwd.live_registers()}" in line


# ---------------------------------------------------------------------------
# tilemax and chunk at the kernels' tiles, against the JAX lab's bodies


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_lab_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def variants_script():
    return _script("exp_flash_variants")


def _jax_lab(mod, variant, block_q, x):
    """exp_flash_variants.make_kernel's body over (B, L, H*64) at grid (B,
    1, L / block_q), in interpret mode."""
    b, l, c = x[0].shape

    def q_map(bi, gi, qi):
        return (bi, qi, gi)

    def kv_map(bi, gi, qi):
        del qi
        return (bi, 0, gi)

    call = pl.pallas_call(
        mod.make_kernel(variant, 1),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(b, 1, l // block_q),
            in_specs=[pl.BlockSpec((1, block_q, c), q_map), pl.BlockSpec((1, l, c), kv_map),
                      pl.BlockSpec((1, l, c), kv_map)],
            out_specs=pl.BlockSpec((1, block_q, c), q_map)),
        out_shape=jax.ShapeDtypeStruct((b, l, c), jnp.bfloat16),
        interpret=True)
    return torch.from_numpy(np.array(call(*x).astype(jnp.float32)))


@pytest.mark.parametrize("variant,l,block_q", [("tilemax", 256, 64), ("chunk", 128, 128)])
def test_plain_versions_at_the_kernel_tiles_match_the_jax_lab(variants_script, monkeypatch,
                                                              variant, l, block_q):
    """tilemax: the JAX body's one max over its (block_q, L) tile, at the
    64 rows of a consumer warpgroup; chunk: the JAX body's two halves of L,
    at L = 128, the kernel's one key tile and its two 64-key halves."""
    h = 2
    monkeypatch.setattr(variants_script, "H", h)
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((1, l, h * D)).astype(np.float32) for _ in range(3)]
    got = _jax_lab(variants_script, variant, block_q, [jnp.asarray(a, jnp.bfloat16)
                                                         for a in arrs])
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    want = FL.flash_variant_plain(q, k, v, variant, D ** -0.5, h, rows=block_q)
    assert float((got - want.float()).abs().max()) <= ATOL


def test_sass_listings_compare_kernel_by_kernel_across_checkouts():
    """The shipped kernels must keep their SASS beside the lab's knobs:
    ``_build.parse_sass`` names a kernel alike in every checkout and drops
    what moves with the build (addresses, encodings), so two builds of one
    source compare equal and a changed instruction shows."""
    def listing(h, op):
        return (f"\t\tFunction : _ZN45_GLOBAL__N__{h}_12_flash_fwd_cu_4d1c0b2a21flash_fwd_sm90"
                "_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_NS_6F9ArgsE\n"
                "\t.headerflags\t@\"EF_CUDA_SM90\"\n"
                f"        /*0000*/        {op} R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */\n"
                "                                                  /* 0x000fe20000000800 */\n"
                "        /*10a30*/       EXIT ;                   /* 0x000000000000794d */\n")
    a = _build.parse_sass(listing("c5a2a33b", "LDC"))
    b = _build.parse_sass(listing("0190a741", "LDC"))
    name = "_ZN<flash_fwd.cu>21flash_fwd_sm90_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_NS_6F9ArgsE"
    assert a == b == {name: ["LDC R1, c[0x0][0x28] ;", "EXIT ;"]}
    assert _build.parse_sass(listing("c5a2a33b", "MOV")) != a


def test_sass_listing_ends_a_kernel_at_the_next_cubins_header():
    """The last kernel of one source's cubin does not take the next cubin's
    header as instructions: a kernel's place in its cubin does not move its
    listing."""
    def function(name, op):
        return (f"\t\tFunction : _ZN45_GLOBAL__N__c5a2a33b_12_flash_bwd_cu_4d1c0b2a{name}\n"
                "\t.headerflags\t@\"EF_CUDA_SM90\"\n"
                f"        /*0000*/        {op} ;  /* 0x00000a00ff017b82 */\n"
                "                                  /* 0x000fe20000000800 */\n"
                "        /*0010*/       NOP;     /* 0x0000000000007918 */\n")

    header = ("\nFatbin elf code:\n================\narch = sm_90a\ncode version = [1,7]\n"
              "host = linux\ncompile_size = 64bit\n\n\tcode for sm_90a\n")
    first = _build.parse_sass(header + function("1aEv", "EXIT") + function("1bEv", "BRA")
                              + header + function("1cEv", "RET"))
    second = _build.parse_sass(header + function("1bEv", "BRA") + function("1aEv", "EXIT")
                               + header + function("1cEv", "RET"))
    assert first == second
    assert first["_ZN<flash_bwd.cu>1bEv"] == ["BRA ;", "NOP;"]
