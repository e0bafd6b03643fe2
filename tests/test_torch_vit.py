"""The port's bsqvit_gq slice end to end against the JAX package.

A tiny engine built from the shipped ``configs/bsqvit_gq_0.25.yaml`` with a
dotlist (width 128, 2 layers, 2 heads, 64x64 images, patch 8, z 16, group
16): the JAX engine's seeded weights go across through
``state_dict_from_jax`` and the same numpy inputs go through both.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.utils.config import load_config as jax_load_config
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
from vqvae_from_gaussian_vae_tpu_torch.models import vit
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import gq_scores_reference
from vqvae_from_gaussian_vae_tpu_torch.utils.config import resolve_target
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "bsqvit_gq_0.25.yaml")
_P = "model.params.encoder_config.params."
TINY = [_P + "width=128", _P + "layers=2", _P + "heads=2", _P + "image_size=64",
        "model.params.loss_config=null"]

FP32_TOL = 1e-3    # float32 on both sides; measured ~2.4e-6
BF16_REL_L2 = 3e-2  # the sd3unet slice's bars: bf16 rounds at other places
BF16_MAX_ABS = 0.1  # (float32 scores here, bf16 einsum scores there);
#                     measured ~8e-3 relative, ~2.5e-2 max abs on |z| <= 3.6
NEAR_TIE = 1e-5     # relative float64 score gap under which two GQ codes tie


def _engines(dtype, params=None, extra=()):
    """(JAX engine, port engine) with the JAX engine's seeded weights, or
    `params`."""
    dot = TINY + [_P + f"dtype={dtype}", *extra]
    cfg, jcfg = load_config(CONFIG, dot), jax_load_config(CONFIG, dot)
    jeng = jax_instantiate(copy.deepcopy(jcfg["model"]))
    if params is None:
        jeng.init_params(jax.random.PRNGKey(0))
    else:
        jeng.params = params
    peng = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu")
    peng.load_state_dict(state_dict_from_jax(jeng.params), strict=True)
    return jeng, peng


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def fp32_engines():
    return _engines("float32")


@pytest.fixture(scope="module")
def bf16_engines(fp32_engines):
    return _engines("bfloat16", params=fp32_engines[0].params)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_fp32_vit_slice_matches_jax(fp32_engines, image):
    jeng, peng = fp32_engines
    x = torch.from_numpy(image)
    zj, _ = jeng.encode(jnp.asarray(image), unregularized=True)
    zp, _ = peng.encode(x, unregularized=True)
    assert zp.shape == (2, 64, 32)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=FP32_TOL, rtol=FP32_TOL)

    zhat_j, info_j = jeng.encode(jnp.asarray(image), return_reg_log=True)
    zhat_p, info_p = peng.encode(x, return_reg_log=True)
    idx_j, idx_p = np.array(info_j["indices"]), info_p["indices"].numpy()
    assert idx_p.shape == idx_j.shape == (2, 64, 1) and idx_p.dtype == np.int32
    z64 = np.asarray(zj).astype(np.float64).reshape(-1, 32)
    mu, std = z64[:, :16], np.exp(0.5 * np.clip(z64[:, 16:], -30, 20))
    cb = peng.regularization.codebook.numpy()
    for r in np.nonzero(idx_p.reshape(-1) != idx_j.reshape(-1))[0]:
        pair = [idx_p.reshape(-1)[r], idx_j.reshape(-1)[r]]
        s = gq_scores_reference(mu[r:r + 1], std[r:r + 1], cb[pair])[0]
        assert abs(s[0] - s[1]) <= NEAR_TIE * max(1.0, abs(s[1])), (r, pair, s)

    deq_j = np.asarray(jeng.dequant(jnp.asarray(idx_j)))
    deq_p = peng.dequant(torch.from_numpy(idx_j))
    assert deq_p.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(deq_p.numpy(), deq_j, atol=FP32_TOL, rtol=FP32_TOL)
    dec_p = peng.decode(torch.from_numpy(np.array(zhat_j)))
    np.testing.assert_array_equal(np.clip(dec_p.numpy(), -1, 1), deq_p.numpy())
    assert torch.equal(peng.dequant(info_p["indices"]), peng.decode(zhat_p).clamp(-1, 1))


def test_bf16_vit_slice_matches_jax(bf16_engines, image):
    """The port's bf16 CPU run walks the streamed LN-add trunk and the packed
    attention with the plain versions; the JAX engine at bf16 on the CPU
    takes its plain XLA path."""
    jeng, peng = bf16_engines
    zj, _ = jeng.encode(jnp.asarray(image), unregularized=True)
    zp, _ = peng.encode(torch.from_numpy(image), unregularized=True)
    assert zp.dtype == torch.bfloat16
    zj, zp = np.asarray(zj, np.float32), zp.float().numpy()
    assert _rel_l2(zp, zj) <= BF16_REL_L2 and np.abs(zp - zj).max() <= BF16_MAX_ABS

    _, info_j = jeng.encode(jnp.asarray(image), return_reg_log=True)
    idx = np.array(info_j["indices"])
    deq_j = np.asarray(jeng.dequant(jnp.asarray(idx)), np.float32)
    deq_p = peng.dequant(torch.from_numpy(idx)).float().numpy()
    assert np.isfinite(deq_p).all()
    assert _rel_l2(deq_p, deq_j) <= BF16_REL_L2 and np.abs(deq_p - deq_j).max() <= BF16_MAX_ABS


@pytest.mark.parametrize("dtype,flash_calls", [("bfloat16", 2), ("float32", 0)])
def test_trunk_routes_through_the_kernel_ops(bf16_engines, fp32_engines, image, monkeypatch,
                                             dtype, flash_calls):
    """Per trunk: ln_pre, block 0's ln_1 and ln_post are plain LN, every
    other norm is LN-add (2 * layers - 1); bf16 attention is the packed
    flash entry where the shape gate takes it, float32 the einsum form.
    These are the launch counts the card sees per trunk.  Here a trunk has
    L = 64 tokens, which neither JAX's gate nor the port's takes (L % 128),
    so bf16 runs the einsum form too; tests/test_torch_gates.py holds the
    routing at L = 128."""
    peng = (bf16_engines if dtype == "bfloat16" else fp32_engines)[1]
    blk = peng.encoder.transformer.resblocks[0]
    tokens = peng.encoder.positional_embedding.shape[0]
    hd = blk.ln_1.weight.shape[0] // blk.attn.n_head
    if not vit.flash_supported(tokens, blk.attn.n_head, hd):
        flash_calls = 0
    calls = {"ln": 0, "ln_add": 0, "flash": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(vit, "layer_norm", counted("ln", vit.layer_norm))
    monkeypatch.setattr(vit, "layer_norm_add", counted("ln_add", vit.layer_norm_add))
    monkeypatch.setattr(vit, "flash_attention_qkv", counted("flash", vit.flash_attention_qkv))
    _, idx = peng.quant(torch.from_numpy(image))
    peng.dequant(idx)
    assert calls == {"ln": 2 * 3, "ln_add": 2 * 3, "flash": 2 * flash_calls}


def test_streamed_trunk_matches_plain_blocks(fp32_engines):
    """The (stream, delta) trunk is the same function as x + attn, x + mlp."""
    trunk = fp32_engines[1].encoder.transformer
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 64, 128)).astype(np.float32))
    with torch.inference_mode():
        want = x
        for blk in trunk.resblocks:
            want = blk(want)
        got = trunk(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_vit_weights_round_trip_through_jax_converter(fp32_engines):
    """A port state_dict loads into the JAX engine through the JAX package's
    own converter, strictly, and gives back the same parameters."""
    jeng, peng = fp32_engines
    sd = {k: v.numpy() for k, v in peng.state_dict().items()}
    assert "encoder.transformer.resblocks.1.attn.in_proj_weight" in sd
    assert sd["decoder.ffn.0.weight"].shape == (3072, 128)
    prefix_map = {"encoder.": "encoder.", "decoder.": "decoder."}
    params, missing, unexpected = convert_state_dict(sd, jeng.params, prefix_map=prefix_map,
                                                     strict=True)
    assert missing == [] and unexpected == []
    flat_in = jax.tree_util.tree_leaves_with_path(jeng.params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_out[path]), np.asarray(leaf))


@pytest.mark.parametrize("width,heads", [(128, 2), (768, 12)])
def test_seeded_engine_is_sane(image, width, heads):
    """Seeded weights (no JAX weights): Linear and in_proj N(0, 1/fan_in),
    positional embedding N(0, 0.02^2), LN (1, 0).  The encoder output has a
    finite, O(1) spread; measured std ~1.0 at both widths."""
    dot = [_P + f"width={width}", _P + "layers=2", _P + f"heads={heads}", _P + "image_size=64",
           "model.params.loss_config=null"]
    eng = instantiate_from_config(copy.deepcopy(load_config(CONFIG, dot)["model"]),
                                  device="cpu", seed=0)
    pos = eng.encoder.positional_embedding
    assert 0.015 < float(pos.detach().std()) < 0.025
    w = eng.encoder.transformer.resblocks[0].attn.in_proj_weight
    assert abs(float(w.detach().std()) * width ** 0.5 - 1.0) < 0.05
    z, _ = eng.encode(torch.from_numpy(image), unregularized=True)
    assert bool(torch.isfinite(z).all()) and 0.3 < float(z.std()) < 3.0
    xhat = eng.dequant(eng.quant(torch.from_numpy(image))[1])
    assert bool(torch.isfinite(xhat).all()) and float(xhat.std()) > 0.05


def test_vit_engine_api_shapes(fp32_engines, image):
    _, peng = fp32_engines
    x = torch.from_numpy(image)
    z, idx = peng.quant(x)
    assert z.shape == (2, 64, 16) and idx.shape == (2, 64, 1)
    z2, xrec, reg = peng(x, eps=torch.zeros((2, 64, 16)))
    assert torch.equal(z2, z) and xrec.shape == (2, 64, 64, 3)
    assert float(xrec.abs().max()) <= 1.0
    np.testing.assert_array_equal(reg["zhat_noquant"].numpy(),
                                  peng.encode(x, unregularized=True)[0][..., :16].numpy())
    dec = peng.decoder
    with torch.inference_mode():
        assert torch.equal(dec.last_layer(dec.pre_last_layer(z)), dec(z))
    from vqvae_from_gaussian_vae_tpu.models.vit import TransformerEncoder as JaxEncoder

    # the encoder's last layer (the vf adaptive weight's target): JAX's path in
    # torch's leaf name, a parameter of the port's encoder
    jpath = JaxEncoder.last_layer_path()
    assert vit.TransformerEncoder.last_layer_path() == jpath[:-1] + ("weight",)
    w = peng.encoder.get_parameter(".".join(vit.TransformerEncoder.last_layer_path()))
    assert w.shape == peng.encoder.quant_embed.weight.shape
    for spelling in ("vqvae_from_gaussian_vae_tpu.models.vit.TransformerDecoder",
                     "pit.modules.vit.TransformerDecoder"):
        assert resolve_target(spelling) == \
            "vqvae_from_gaussian_vae_tpu_torch.models.vit.TransformerDecoder"


def test_dtype_dotlist_reaches_both_backbones():
    cfg = load_config(CONFIG, TINY + [_P + "dtype=bfloat16"])
    eng = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu")
    assert eng.encoder.dtype == eng.decoder.dtype == torch.bfloat16
    # the weights are float32 master copies; the Linear layers compute in bf16
    assert eng.decoder.conv_out.weight.dtype == torch.float32
    assert eng.decoder.conv_out.compute_dtype == torch.bfloat16
    assert eng.decoder.transformer.resblocks[0].ln_1.weight.dtype == torch.float32


@pytest.mark.parametrize("mask_type", ["causal", "block-causal"])
def test_masked_attention_matches_jax(mask_type):
    """The masked einsum branch against the JAX module at float32."""
    from vqvae_from_gaussian_vae_tpu.models import vit as jvit

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    jmask = jvit.get_attention_mask(32, mask_type, 8)
    mask = vit.get_attention_mask(32, mask_type, 8)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    jmod = jvit.MultiheadAttention(64, 4)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jmask)["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x), jmask)
    mod = vit.MultiheadAttention(64, 4)
    mod.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = mod(torch.from_numpy(x), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_vit_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import vqvae_from_gaussian_vae_tpu_torch as p\n"
        "from vqvae_from_gaussian_vae_tpu_torch.models import vit\n"
        "from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm, flash_attention\n"
        f"dot = {TINY!r}\n"
        "cfg = p.load_config('configs/bsqvit_gq_0.25.yaml', dot)\n"
        "p.instantiate_from_config(cfg['model'], device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'vqvae_from_gaussian_vae_tpu'\n"
        "       or m.startswith('vqvae_from_gaussian_vae_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
