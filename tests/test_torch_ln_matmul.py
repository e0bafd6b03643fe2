"""The port's LayerNorm-prologue matmul lab (``ops/ln_matmul.py``,
``labs/exp_ln_matmul.py``) against the JAX lab ``scripts/exp_ln_matmul.py``.

The JAX lab's Pallas bodies run only on a TPU, so here its own
``_pallas_fused`` and ``_pallas_mm`` run under
``pltpu.force_tpu_interpret_mode()`` at small shapes (N off the port's
128-column tile), and the port's plain versions, which the kernels are held
to on the card, are held to them; the ``xla`` site's plain form is held to
the JAX package's ``layer_norm`` + ``@`` + ``wb``.  The script is imported by
path and not changed.  Bar: 1e-2 of max |reference|, one bf16 ulp at the
largest output (the float32 sums run in another order).  Also the lab's
command line, its row-block refusal, its numbers, and the wrappers'
refusals.
"""

import ast
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from vqvae_from_gaussian_vae_tpu_torch.labs import exp_ln_matmul as lab
from vqvae_from_gaussian_vae_tpu_torch.ops import ln_matmul as LM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "exp_ln_matmul.py")
REL = 1e-2
# (R, C, N, bm): R a multiple of the JAX lab's bm (its grid is R // bm); N
# not a multiple of the port's 128-column tile
SHAPES = [(512, 128, 200, 256), (256, 256, 136, 128)]


def _script():
    spec = importlib.util.spec_from_file_location("jax_lab_exp_ln_matmul", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_lab():
    return _script()


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module", params=SHAPES, ids=[f"{r}x{c}x{n}-bm{bm}"
                                                    for r, c, n, bm in SHAPES])
def case(request, jax_lab):
    """Inputs drawn as the lab draws them, rounded to bf16 from float32 on
    both sides, and the JAX lab's outputs at them."""
    r, c, n, bm = request.param
    rng = np.random.default_rng(0)
    x = rng.standard_normal((r, c)).astype(np.float32)
    g = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    w = (rng.standard_normal((c, n)) * 0.02).astype(np.float32)
    wb = (rng.standard_normal(n) * 0.01).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jg, jb, jwb = jnp.asarray(g), jnp.asarray(b), jnp.asarray(wb)
    y = jax_layer_norm(jx, jg, jb, lab.EPS, True)
    with pltpu.force_tpu_interpret_mode():
        fused = jax_lab._pallas_fused(jx, jg, jb, jw, jwb, bm)
        mm = jax_lab._pallas_mm(y, jw, jwb, bm)
    xla = (y @ jw + jwb.astype(jnp.float32)).astype(jx.dtype)
    ref = (jax_lab._ln_ref(jx, jg, jb).astype(jnp.float32) @ jw.astype(jnp.float32)
           + jwb).astype(jnp.bfloat16)
    t = [torch.from_numpy(a) for a in (x, g, b, w, wb)]
    tx, tw = t[0].to(torch.bfloat16), t[3].to(torch.bfloat16)
    return {"torch": (tx, t[1], t[2], tw, t[4]),
            "y": torch.from_numpy(_np(y)).to(torch.bfloat16),
            **{k: torch.from_numpy(_np(v)) for k, v in
               (("fused", fused), ("mm", mm), ("xla", xla), ("ref", ref))}}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def test_ln_matmul_plain_matches_the_jax_fused_kernel(case):
    got = LM.ln_matmul_plain(*case["torch"])
    assert got.dtype == torch.bfloat16
    assert _rel(got, case["fused"]) <= REL


def test_matmul_bias_plain_matches_the_jax_mm_kernel(case):
    """On the JAX LN kernel's own bf16 output, which the port's LN rows match."""
    tx, tg, tb, tw, twb = case["torch"]
    assert _rel(LM.layer_norm_rows(tx, tg, tb), case["y"]) <= REL
    assert _rel(LM.matmul_bias_plain(case["y"], tw, twb), case["mm"]) <= REL


def test_xla_plain_matches_the_jax_xla_site(case):
    assert _rel(LM.ln_matmul_xla_plain(*case["torch"]), case["xla"]) <= REL


def test_lab_reference_and_plain_sites_match_the_jax_lab(case):
    """The fused plain version is the JAX lab's ``max_err`` reference; pmm
    and fused share one plain function, xla its own."""
    args = case["torch"]
    assert _rel(LM.ln_matmul_plain(*args), case["ref"]) <= REL
    assert torch.equal(lab.plain_site("pmm", *args), lab.plain_site("fused", *args))
    assert torch.equal(lab.plain_site("xla", *args), LM.ln_matmul_xla_plain(*args))


def test_one_rounding_and_two_roundings_are_told_apart(case):
    """The fused plain version rounds once and the xla one twice: they
    differ in many elements, by at most one bf16 ulp of the largest output,
    and each matches its own JAX counterpart in more elements than the
    other's."""
    fused, xla = LM.ln_matmul_plain(*case["torch"]), LM.ln_matmul_xla_plain(*case["torch"])
    assert (fused != xla).float().mean() > 0.05
    assert _rel(xla, fused) <= 2.0 ** -7

    def mismatches(a, b):
        return int((a.float() != b.float()).sum())

    assert mismatches(fused, case["fused"]) < mismatches(fused, case["xla"])
    assert mismatches(xla, case["xla"]) < mismatches(xla, case["fused"])


def _jax_default_combos():
    """The ``combos`` list of the JAX lab's ``__main__`` block, read from its
    source."""
    tree = ast.parse(open(SCRIPT).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "combos"
                                                for t in node.targets):
            if isinstance(node.value, ast.List) and node.value.elts:
                return [tuple(x) for x in ast.literal_eval(node.value)]
    raise AssertionError("no default combos in the JAX lab")


def test_default_combos_are_the_jax_labs_and_each_has_a_counterpart():
    jax_defaults = _jax_default_combos()
    assert lab.JAX_DEFAULTS == jax_defaults and len(jax_defaults) == 7
    assert lab.DEFAULT_COMBOS == jax_defaults + [lab.PORT_COMBO]
    for variant, bm, n in lab.DEFAULT_COMBOS:
        LM.check_tiling(bm)  # every default row block is compiled: no skipped line
        # bm sets the raster, not the grid: every combo fills the card's 132
        # SMs, one 230,464-byte block each (under the 232,448 a block may have)
        plan = LM.ln_matmul_plan(lab.R, lab.WIDTH, n, bm)
        assert plan.grid == LM.SMS == 132 and plan.tiles >= 8 * plan.grid
        assert plan.group == bm // 128 and plan.smem == LM.smem_bytes() == 230_464 <= 232_448
    assert lab.PORT_COMBO == ("fused", 128, 2304)


def test_command_line_parses_the_jax_syntax():
    assert lab.parse_combos(["fused:256:3072", "xla", "pmm:128", "fused:1024"]) == [
        ("fused", 256, 3072), ("xla", 512, 2304), ("pmm", 128, 2304), ("fused", 1024, 2304)]
    # the xla site does not read bm (nor does the JAX lab's)
    assert lab.parse_combos(["xla:100:3072"]) == [("xla", 100, 3072)]


@pytest.mark.parametrize("arg", ["fused:64", "pmm:192:2304", "fused:0", "softmax:512"])
def test_command_line_refuses_uncompiled_row_blocks_and_unknown_variants(arg):
    with pytest.raises(ValueError, match="not compiled|unknown variant"):
        lab.parse_combos([arg])


def test_bound_of_one_site():
    """58.6 us at N = 2304 and 78.2 us at 3072: operations bound."""
    flops, nbytes = lab.flops_bytes("fused", 2304)
    assert flops == 2 * 16384 * 768 * 2304 and nbytes == 104_217_600
    bound, by = lab.C.bound_ms(flops, nbytes)
    assert by == "operations" and abs(bound - 0.0586) < 5e-4
    bound, by = lab.C.bound_ms(*lab.flops_bytes("fused", 3072))
    assert by == "operations" and abs(bound - 0.0782) < 5e-4
    assert lab.flops_bytes("pmm", 2304)[1] == nbytes - 8 * 768


def test_ptxas_report_is_matched_to_a_kernel():
    usage = {"_ZN12_GLOBAL__N_116ln_matmul_kernelILb1EEEvNS_8LnMmArgsE": {"registers": 168},
             "_ZN12_GLOBAL__N_116ln_matmul_kernelILb0EEEvNS_8LnMmArgsE": {"registers": 128}}
    assert LM.ptxas_of(usage, True) == {"registers": 168}
    assert LM.ptxas_of(usage, False) == {"registers": 128}
    assert LM.ptxas_of({}, True) == {}


def test_kernel_wrappers_refuse_cpu_tensors_grad_and_bad_shapes():
    x, g, b, w, wb = lab.lab_inputs(256, rows=128, width=128, device="cpu")
    before = (LM.ln_matmul_cuda.launches, LM.matmul_bias_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        LM.ln_matmul_cuda(x, g, b, w, wb, 128)
    with pytest.raises(ValueError, match="CUDA"):
        LM.matmul_bias_cuda(x, w, wb, 128)
    with pytest.raises(RuntimeError, match="autograd"):
        LM.ln_matmul_cuda(x, g.requires_grad_(), b, w, wb, 128)
    with pytest.raises(RuntimeError, match="autograd"):
        LM.matmul_bias_cuda(x, w.requires_grad_(), wb, 128)
    assert (LM.ln_matmul_cuda.launches, LM.matmul_bias_cuda.launches) == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            lab.run("fused", 512, 2304)


def test_kernel_registers_name_a_kernel_alike_in_every_checkout():
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    def log(h1, h2):
        return (f"ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__{h1}_12_ln_matmul_cu_"
                f"{h2}16ln_matmul_kernelILb1EEEvNS_8LnMmArgsE' for 'sm_90a'\n"
                "ptxas info    : Used 167 registers, used 1 barriers\n")

    a, b = _build.kernel_registers(log("c5a2a33b", "c8bd3a00")), \
        _build.kernel_registers(log("0190a741", "4848b001"))
    assert a == b == {"_ZN<ln_matmul.cu>16ln_matmul_kernelILb1EEEvNS_8LnMmArgsE": 167}
    # the card test's table: every shipped kernel by its stable name (the
    # weight-gradient body in two tile widths for each of its three sources;
    # the wgmma flash backward's di pre-pass at D = 64, 128, 256 and 512; the
    # implicit-GEMM body, four downsample forward, two downsample dgrad, two
    # upsample dgrad, four upsample forward and two fused GroupNorm conv kernels;
    # the wide flash forward body at D = 256 and 512; the float32 head-major op's
    # split-TF32 forward, dK/dV and dQ kernels at D = 64 and 128 and their
    # pre-pass; the wide flash backward body's dK/dV and dQ kernels at D = 256
    # and 512; the flash labs' 28 forward and 20 backward kernels and the di
    # pre-pass at D = 64 on the wgmma bodies; the float32 op's wide split-TF32
    # forward, dK/dV and dQ kernels at D = 256 and 512, with and without the key
    # mask; the float32 fused GroupNorm conv's split-TF32 kernel and its weight
    # pre-pass, in place of the SIMT kernel; this lab's GEMM body, fused and
    # plain, and its statistics pass; the GroupNorm + swish backward's one
    # kernel in two dtypes and the LayerNorm backward's 36 (each dtype and row
    # class, with and without the add), in place of their four and two kernels
    # a call)
    with open(os.path.join(ROOT, "tests", "torch_kernel_registers.json")) as f:
        table = json.load(f)
    assert len(table) == 215 and sum("<ln_matmul.cu>" in k for k in table) == 3
    assert not any("fused_gn_conv_f32_kernel" in k for k in table)
    assert all(k.count("<") == 1 and k.count(".cu>") == 1 for k in table)
