"""The port's choice between a kernel and its plain path, site by site,
against the JAX package's: the attention front door ``sdpa_token_major``,
the ViT's ``MultiheadAttention`` and ``FusedLayerNorm``, and the resample
backwards' ``GVQ_DOWNSAMPLE_BWD`` / ``GVQ_UPSAMPLE_BWD`` switches.

Each JAX gate is taken with its "backend is TPU" clause met.  The flash
gates differ from JAX's in the documented classes only
(``ops/flash_attention.py``): a head dim the Hopper kernels do not take
(JAX kernel, port einsum), a shape whose TPU tiling does not fit VMEM (JAX
einsum, port kernel), and, at the ViT's attention, float32 values (the
port's kernels take bf16).  Then a small sd3unet at 40x40, whose AttnBlocks
(20x20 = 400 tokens) take the einsum path, against the JAX engine in
float32, and the conv-form resample backward against JAX's.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.ops import downsample_conv as jdown
from vqvae_from_gaussian_vae_tpu.ops import flash_blc as jflash
from vqvae_from_gaussian_vae_tpu.ops import upsample_conv as jup
from vqvae_from_gaussian_vae_tpu.utils.config import load_config as jax_load_config
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
from vqvae_from_gaussian_vae_tpu_torch.models import vit
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

LS = (64, 128, 200, 625, 1024, 4096, 8192)
HS = (1, 4, 12)
DS = (8, 32, 64, 96, 128, 256, 512)
DTYPES = ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32))
FP32_TOL = 1e-4  # float32 on both sides: summation order only

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_P = "model.params.encoder_config.params."
TINY_UNET = [_P + "ch=32", _P + "ch_mult=[1,2]", _P + "num_res_blocks=1", _P + "resolution=32",
             _P + "attn_resolutions=[16]", "model.params.loss_config=null"]


def _setenv(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _difference(l, h, d, port: bool, jax_gate: bool, tdt) -> str:
    """Which documented class a disagreement of the port's flash gate with
    JAX's falls in ("" where they agree); raises for any other."""
    if port == jax_gate:
        return ""
    if jax_gate and d % 8 == 0 and d not in fa.SUPPORTED_HEAD_DIMS:
        return "head dim"
    if port and jflash._fwd_tiling(l, h, d, 2) is None:
        return "vmem"
    if jax_gate and tdt == torch.float32:
        return "float32"
    raise AssertionError(f"the gates differ outside the documented classes at L={l}, H={h}, "
                         f"D={d}, {tdt}: port {port}, JAX {jax_gate}")


@pytest.mark.parametrize("disable", [None, "1", "0"])
def test_flash_gates_differ_from_jax_only_in_the_documented_classes(monkeypatch, disable):
    _setenv(monkeypatch, "GVQ_DISABLE_FUSED_KERNELS", disable)
    off = disable == "1"
    seen = set()
    for l in LS:
        for h in HS:
            for d in DS:
                # the shape predicate alone, then the front door's gate
                seen.add(_difference(l, h, d, fa.flash_supported(l, h, d),
                                     jflash.flash_blc_supported(l, h, d, jnp.bfloat16),
                                     torch.bfloat16))
                for tdt, jdt in DTYPES:
                    jax_sdpa = (jdt == jnp.bfloat16 and not off
                                and jflash.flash_blc_supported(l, h, d, jdt))
                    port = fa.sdpa_uses_flash(tdt, l, h, d)
                    assert _difference(l, h, d, port, jax_sdpa, tdt) in ("", "head dim", "vmem")
                    for flash in (True, False):
                        for masked in (False, True):
                            jax_mha = (flash and not masked and not off
                                       and jflash.flash_blc_supported(l, h, d, jdt))
                            port = vit.mha_uses_flash(flash, masked, tdt, l, h, d)
                            seen.add(_difference(l, h, d, port, jax_mha, tdt))
    assert {"head dim", "vmem"} <= seen and seen <= {"", "head dim", "vmem", "float32"}
    # the example the module names: D = 512, H = 1, L = 4096
    assert fa.flash_supported(4096, 1, 512) and not jflash.flash_blc_supported(
        4096, 1, 512, jnp.bfloat16)


@pytest.mark.parametrize("disable", [None, "1", "0"])
def test_layer_norm_gate_reads_the_environment_as_jax(monkeypatch, disable):
    _setenv(monkeypatch, "GVQ_DISABLE_FUSED_KERNELS", disable)
    for c in (64, 96, 128, 768):
        assert vit.layer_norm_uses_kernel(c) == (c % 128 == 0 and disable != "1"), c


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def fn(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, fn)


@pytest.mark.parametrize("disable", [None, "1"])
def test_vit_sites_take_the_path_their_gate_names(monkeypatch, disable):
    """A bf16 attention of 128 tokens and a 128-wide LayerNorm take the
    kernel ops unless the kernels are disabled; flash=False, a mask or a
    96-wide row take the plain paths, and each path gives the same values."""
    _setenv(monkeypatch, "GVQ_DISABLE_FUSED_KERNELS", disable)
    torch.manual_seed(0)
    x = torch.randn((2, 128, 128)).to(torch.bfloat16)
    calls = {}
    for name in ("flash_attention_qkv", "layer_norm", "layer_norm_add"):
        _spy(monkeypatch, vit, name, calls)
    attn = vit.MultiheadAttention(128, 2, dtype="bfloat16")
    torch.nn.init.normal_(attn.in_proj_weight, std=128 ** -0.5)
    plain = vit.MultiheadAttention(128, 2, flash=False, dtype="bfloat16")
    plain.load_state_dict(attn.state_dict())
    with torch.no_grad():
        got, want = attn(x), plain(x)
        mask = vit.get_attention_mask(128, "causal")
        attn(x, mask)
        ln = vit.FusedLayerNorm(128, dtype="bfloat16")
        ln(x), ln(x, add=x)
        vit.FusedLayerNorm(96, dtype="bfloat16")(x[..., :96])
    assert calls == ({} if disable == "1" else {"flash_attention_qkv": 1, "layer_norm": 1,
                                                "layer_norm_add": 1})
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("value", [None, "conv", "pallas", "1"])
def test_resample_bwd_switches_read_the_environment_as_jax(monkeypatch, value):
    """Which backward JAX's ``_down_bwd_impl_t`` / ``_bwd_impl_t`` call under
    the variable, against the port's switch."""
    taken = []
    for name in ("GVQ_DOWNSAMPLE_BWD", "GVQ_UPSAMPLE_BWD"):
        _setenv(monkeypatch, name, value)
    for mod, conv, pallas in ((jdown, "_downsample_bwd_conv", "_downsample_bwd_pallas_t"),
                              (jup, "_upsample_bwd_conv", "_upsample_bwd_pallas_t")):
        monkeypatch.setattr(mod, conv, lambda *a: taken.append("conv"))
        monkeypatch.setattr(mod, pallas, lambda *a: taken.append("kernels"))
    z = jnp.zeros((1, 1, 1, 1))
    jdown._down_bwd_impl_t(z, z, z, z, None)
    jup._bwd_impl_t(z, z, z, z, None)
    assert taken == ["conv" if down.downsample_bwd_uses_conv() else "kernels",
                     "conv" if up.upsample_bwd_uses_conv() else "kernels"]
    assert down.downsample_bwd_uses_conv() == up.upsample_bwd_uses_conv() == (value == "conv")


@pytest.mark.parametrize("op", ["down", "up"])
@pytest.mark.parametrize("with_add", [False, True])
def test_conv_form_resample_bwd_matches_jax(monkeypatch, op, with_add):
    """With ``GVQ_*_BWD=conv`` the port's resample backward on CPU tensors
    is JAX's conv-form adjoint (float32), and no dgrad or wgrad runs."""
    monkeypatch.setenv("GVQ_DOWNSAMPLE_BWD" if op == "down" else "GVQ_UPSAMPLE_BWD", "conv")
    mod, fn, jfn = ((down, down.downsample_conv3x3_gn, jdown._downsample_bwd_conv)
                    if op == "down" else
                    (up, up.upsample_nearest_conv3x3_gn, jup._upsample_bwd_conv))
    for name in [n for n in dir(mod) if n.endswith(("_dgrad_plain", "_wgrad_plain"))]:
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("a kernel's plain version ran"))
    rng = np.random.default_rng(5)
    b, h, c, o = 2, 8, 32, 64
    x, add = (rng.standard_normal((b, h, h, c)).astype(np.float32) for _ in range(2))
    w = (rng.standard_normal((3, 3, c, o)) / (3 * c ** 0.5)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    ho = h // 2 if op == "down" else 2 * h
    gy = rng.standard_normal((b, ho, ho, o)).astype(np.float32)
    gstats = (0.01 * rng.standard_normal((b, 2, o))).astype(np.float32)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, add, w, bias)]
    y, stats = fn(leaves[0], leaves[2], leaves[3], add=leaves[1] if with_add else None)
    ((y * torch.from_numpy(gy)).sum() + (stats * torch.from_numpy(gstats)).sum()).backward()

    xin = x + add if with_add else x
    dx, dw, dbias = jfn(jnp.asarray(xin), jnp.asarray(w), jnp.asarray(y.detach().numpy()),
                        jnp.asarray(gy), jnp.asarray(gstats))
    for got, want in ((leaves[0].grad, dx), (leaves[2].grad, dw), (leaves[3].grad, dbias)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL, rtol=FP32_TOL)
    if with_add:
        assert torch.equal(leaves[1].grad, leaves[0].grad)


@pytest.fixture(scope="module")
def unet_engines():
    """(JAX engine, port engine at float32, port engine at bf16), the JAX
    engine's seeded weights in all three."""
    path = os.path.join(ROOT, "configs", "sd3unet_gq_0.25.yaml")
    engines = []
    for dtype in ("float32", "bfloat16"):
        dot = TINY_UNET + [_P + f"dtype={dtype}"]
        if not engines:
            jeng = jax_instantiate(copy.deepcopy(jax_load_config(path, dot)["model"]))
            jeng.init_params(jax.random.PRNGKey(0))
            engines.append(jeng)
        peng = instantiate_from_config(copy.deepcopy(load_config(path, dot)["model"]),
                                       device="cpu")
        peng.load_state_dict(state_dict_from_jax(engines[0].params), strict=True)
        engines.append(peng)
    return engines


def test_unet_attention_off_the_flash_shapes_takes_einsum(unet_engines, monkeypatch):
    """At 40x40 the AttnBlocks see 20x20 = 400 tokens (not a multiple of
    128): the bf16 engine sends no attention to the flash op (at 32x32, 256
    tokens, it does), and the float32 engine matches JAX's."""
    jeng, peng32, peng16 = unet_engines
    image = np.random.default_rng(0).uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    zj, _ = jeng.encode(jnp.asarray(image), unregularized=True)
    zp, _ = peng32.encode(torch.from_numpy(image), unregularized=True)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=FP32_TOL, rtol=FP32_TOL)
    zhat_j, _ = jeng.encode(jnp.asarray(image), return_reg_log=True)
    dj = jeng.decode(zhat_j)
    dp = peng32.decode(torch.from_numpy(np.array(zhat_j)))
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), atol=FP32_TOL, rtol=FP32_TOL)

    calls = {}
    _spy(monkeypatch, fa, "flash_attention", calls)
    with torch.no_grad():
        z16, _ = peng16.encode(torch.from_numpy(image), return_reg_log=True)
        d16 = peng16.decode(z16)
    assert calls == {} and bool(torch.isfinite(d16.float()).all())
    with torch.no_grad():
        peng16.encode(torch.from_numpy(image[:, :32, :32]), unregularized=True)
    assert calls.get("flash_attention", 0) > 0


def test_port_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, imports in a process in
    which ``jax`` and the JAX package cannot be imported; and no source
    file of the port names either in an import."""
    import ast
    import subprocess
    import sys

    code = ("import importlib, pkgutil, sys\n"
            "for name in ('jax', 'jaxlib', 'vqvae_from_gaussian_vae_tpu'):\n"
            "    sys.modules[name] = None  # importing it now raises ImportError\n"
            "import chip_smoke\n"
            "import vqvae_from_gaussian_vae_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
    pkg_dir = os.path.join(ROOT, "vqvae_from_gaussian_vae_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, names in os.walk(pkg_dir) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "vqvae_from_gaussian_vae_tpu"), (path, name)
