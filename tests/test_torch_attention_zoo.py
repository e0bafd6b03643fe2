"""The port's attention zoo (``models/attention.py``) and the UNet's linear
attention against the JAX package's modules.

Each zoo class gets random parameters on its JAX module's
``jax.eval_shape`` tree, carried into the port by ``state_dict_from_jax``
(strict), and the same numpy inputs: float32 within 1e-4.  An ``attn_type:
linear`` sd3unet engine (the shipped config cut to a tiny width) goes the
other way: the port's seeded weights load into the JAX engine through the
JAX package's ``convert_state_dict`` with ``strict=True``, then encode
within 1e-4 and indices equal.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.models import attention as jatt
from vqvae_from_gaussian_vae_tpu.utils.config import load_config as jax_load_config
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
from vqvae_from_gaussian_vae_tpu_torch.models import attention as patt
from vqvae_from_gaussian_vae_tpu_torch.models import unet as punet
from vqvae_from_gaussian_vae_tpu_torch.utils.config import resolve_target
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

TOL = 1e-4
B, L, LC = 2, 16, 8          # batch, tokens, context tokens
SEQ, CTX = (B, L, 32), (B, LC, 24)
GRID = (B, 8, 8, 64)         # NHWC; GroupNorm's 32 groups need C % 32 == 0

# name -> (JAX module, port module, input shapes, call keywords from inputs)
CASES = {
    "CrossAttention": (jatt.CrossAttention(32, context_dim=24, heads=2, dim_head=16),
                       patt.CrossAttention(32, context_dim=24, heads=2, dim_head=16),
                       (SEQ, CTX), "context_mask"),
    "CrossAttention_self": (jatt.CrossAttention(32, heads=4, dim_head=8),
                            patt.CrossAttention(32, heads=4, dim_head=8), (SEQ,), ""),
    "SelfAttention": (jatt.SelfAttention(32, num_heads=4, qkv_bias=True),
                      patt.SelfAttention(32, num_heads=4, qkv_bias=True), (SEQ,), ""),
    "SpatialSelfAttention": (jatt.SpatialSelfAttention(64), patt.SpatialSelfAttention(64),
                             (GRID,), ""),
    "GEGLU": (jatt.GEGLU(48), patt.GEGLU(32, 48), (SEQ,), ""),
    "FeedForward": (jatt.FeedForward(32, dim_out=40), patt.FeedForward(32, dim_out=40),
                    (SEQ,), ""),
    "FeedForward_gelu": (jatt.FeedForward(32, mult=2, glu=False),
                         patt.FeedForward(32, mult=2, glu=False), (SEQ,), ""),
    "BasicTransformerBlock": (jatt.BasicTransformerBlock(32, 2, 16, context_dim=24),
                              patt.BasicTransformerBlock(32, 2, 16, context_dim=24),
                              (SEQ, CTX), "context"),
    "BasicTransformerSingleLayerBlock": (
        jatt.BasicTransformerSingleLayerBlock(32, 2, 16, context_dim=24, gated_ff=False),
        patt.BasicTransformerSingleLayerBlock(32, 2, 16, context_dim=24, gated_ff=False),
        (SEQ, CTX), "context"),
    "SimpleTransformer": (jatt.SimpleTransformer(32, 2, 2, 16),
                          patt.SimpleTransformer(32, 2, 2, 16), (SEQ,), ""),
    "SpatialTransformer": (jatt.SpatialTransformer(64, 2, 16, depth=1, context_dim=24),
                           patt.SpatialTransformer(64, 2, 16, depth=1, context_dim=24),
                           (GRID, CTX), "context"),
}


def _call_args(shapes, kind, rng):
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kwargs = {}
    if kind:
        kwargs["context"] = arrays.pop(1)
    if kind == "context_mask":
        kwargs["mask"] = np.arange(LC)[None, :] < np.array([[LC], [LC - 3]])
    return arrays, kwargs


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_class_matches_jax(name):
    jmod, pmod, shapes, kind = CASES[name]
    rng = np.random.default_rng(len(name))
    arrays, kwargs = _call_args(shapes, kind, rng)
    jargs = [jnp.asarray(a) for a in arrays]
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    tree = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs, **jkw))["params"]
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
                          tree)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, *jargs, **jkw))
    pmod.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = pmod(*map(torch.from_numpy, arrays),
                   **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_zoo_registry_takes_both_spellings():
    for cls in ("CrossAttention", "SpatialTransformer", "BasicTransformerBlock"):
        for prefix in ("vqvae_from_gaussian_vae_tpu.models.attention", "pit.modules.attention"):
            assert resolve_target(f"{prefix}.{cls}") == \
                f"vqvae_from_gaussian_vae_tpu_torch.models.attention.{cls}"
    assert patt.MemoryEfficientCrossAttention is patt.CrossAttention
    assert patt.LinAttnBlock is punet.LinAttnBlock


# ---------------------------------------------------------------------------
# the UNet with attn_type: linear

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "sd3unet_gq_0.25.yaml")
_P = "model.params.encoder_config.params."
LINEAR = [_P + "ch=32", _P + "ch_mult=[1,2]", _P + "num_res_blocks=1", _P + "resolution=32",
          _P + "attn_resolutions=[16]", _P + "attn_type=linear", "model.params.loss_config=null"]


@pytest.fixture(scope="module")
def linear_engines():
    """(JAX engine, port engine): the port's seeded weights, loaded into the
    JAX engine strictly by its own converter."""
    cfg, jcfg = load_config(CONFIG, LINEAR), jax_load_config(CONFIG, LINEAR)
    peng = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu")
    jeng = jax_instantiate(copy.deepcopy(jcfg["model"]))
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    rng = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda x: jeng.module.init({"params": rng, "sample": rng}, x,
                                                     train=False)["params"], x)
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)
    params, missing, unexpected = convert_state_dict(peng.state_dict(), template, strict=True)
    assert missing == [] and unexpected == []
    jeng.params = params
    return jeng, peng


def test_linear_attention_blocks_are_where_jax_puts_them(linear_engines):
    _, peng = linear_engines
    assert isinstance(peng.encoder.down[1].attn[0], punet.LinAttnBlock)
    assert isinstance(peng.decoder.up[1].attn[1], punet.LinAttnBlock)
    keys = set(peng.state_dict())
    assert {"encoder.down.1.attn.0.to_qkv.weight", "encoder.down.1.attn.0.to_out.bias",
            "decoder.up.1.attn.1.to_out.weight"} <= keys
    assert not any(k.endswith(".to_qkv.bias") for k in keys)


def test_linear_attention_weights_round_trip(linear_engines):
    """state_dict_from_jax gives back the port's own state_dict."""
    jeng, peng = linear_engines
    back = state_dict_from_jax(jeng.params)
    sd = peng.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_linear_attention_engine_matches_jax(linear_engines):
    jeng, peng = linear_engines
    image = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(image)
    zj, _ = jeng.encode(jnp.asarray(image), unregularized=True)
    zp, _ = peng.encode(x, unregularized=True)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=TOL, rtol=TOL)
    _, info_j = jeng.encode(jnp.asarray(image), return_reg_log=True)
    _, info_p = peng.encode(x, return_reg_log=True)
    np.testing.assert_array_equal(info_p["indices"].numpy(), np.asarray(info_j["indices"]))
    deq_j = np.asarray(jeng.dequant(info_j["indices"]))
    deq_p = peng.dequant(info_p["indices"]).numpy()
    np.testing.assert_allclose(deq_p, deq_j, atol=TOL, rtol=TOL)


def test_linear_block_alone_matches_jax():
    """One LinAttnBlock at bf16 compute against the JAX block (bf16 values
    round at other places: 2e-2)."""
    from vqvae_from_gaussian_vae_tpu.models.unet import LinAttnBlock as JaxLinAttn

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    for dtype, tol in ((jnp.float32, TOL), (jnp.bfloat16, 2e-2)):
        jmod = JaxLinAttn(32, dtype=dtype)
        tree = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
        params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.2).astype(np.float32),
                              tree)
        xj = jnp.asarray(x, dtype)
        want = np.asarray(jax.jit(jmod.apply)({"params": params}, xj), np.float32)
        pmod = punet.LinAttnBlock(32, dtype=torch.bfloat16 if dtype == jnp.bfloat16
                                  else torch.float32)
        pmod.load_state_dict(state_dict_from_jax(params), strict=True)
        xt = torch.from_numpy(np.array(xj, np.float32)).to(pmod.to_out.compute_dtype)
        with torch.no_grad():
            got = pmod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
