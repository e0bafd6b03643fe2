"""The port's sd3unet_gq slice end to end against the JAX package.

A tiny engine built from the shipped ``configs/sd3unet_gq_0.25.yaml`` with a
dotlist (ch 32, ch_mult [1, 2], one res block, attention at 16x16, z 16,
group 16, 32x32 images): the JAX engine's seeded weights go across through
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

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.utils.config import load_config as jax_load_config
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import gq_scores_reference
from vqvae_from_gaussian_vae_tpu_torch.utils.config import resolve_target
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "sd3unet_gq_0.25.yaml")
_P = "model.params.encoder_config.params."
TINY = [_P + "ch=32", _P + "ch_mult=[1,2]", _P + "num_res_blocks=1", _P + "resolution=32",
        _P + "attn_resolutions=[16]", "model.params.loss_config=null"]

FP32_TOL = 1e-3    # float32 on both sides; measured ~3e-6
BF16_REL_L2 = 3e-2  # bf16 rounds at other places in the two packages (fused
BF16_MAX_ABS = 0.1  # stats handoff and deferred add here, plain XLA there);
#                     measured ~1.3e-2 relative, ~3e-2 max abs on |x| <= 3
NEAR_TIE = 1e-5     # relative float64 score gap under which two GQ codes tie


def _configs(dtype, extra=()):
    dot = TINY + [_P + f"dtype={dtype}", *extra]
    return load_config(CONFIG, dot), jax_load_config(CONFIG, dot)


def _engines(dtype, extra=(), params=None):
    """(JAX engine, port engine) with the JAX engine's seeded weights, or
    `params` (float32 either way: the dtype knob sets the compute dtype)."""
    cfg, jcfg = _configs(dtype, extra)
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
    return np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def fp32_engines():
    return _engines("float32")


@pytest.fixture(scope="module")
def bf16_engines(fp32_engines):
    return _engines("bfloat16", params=fp32_engines[0].params)


def _rows(z, group=16):
    """(B, h, w, 2C) raw encoder output -> float64-ready (mu, std) rows with
    the regularizer's strided grouping."""
    b, h, w, c2 = z.shape
    c = c2 // 2
    mu, logvar = z[..., :c].astype(np.float64), np.clip(z[..., c:], -30, 20)
    std = np.exp(0.5 * logvar.astype(np.float64))

    def rows(t):
        return t.reshape(b, h * w, group, c // group).transpose(0, 1, 3, 2).reshape(-1, group)

    return rows(mu), rows(std)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_fp32_slice_matches_jax(fp32_engines, image):
    jeng, peng = fp32_engines
    x = torch.from_numpy(image)
    zj, _ = jeng.encode(jnp.asarray(image), unregularized=True)
    zp, _ = peng.encode(x, unregularized=True)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=FP32_TOL, rtol=FP32_TOL)

    zhat_j, info_j = jeng.encode(jnp.asarray(image), return_reg_log=True)
    zhat_p, info_p = peng.encode(x, return_reg_log=True)
    idx_j, idx_p = np.array(info_j["indices"]), info_p["indices"].numpy()
    assert idx_p.shape == idx_j.shape == (2, 16, 16, 1) and idx_p.dtype == np.int32
    mu, std = _rows(np.asarray(zj))
    cb = peng.regularization.codebook.numpy()
    for r in np.nonzero(idx_p.reshape(-1) != idx_j.reshape(-1))[0]:
        pair = [idx_p.reshape(-1)[r], idx_j.reshape(-1)[r]]
        s = gq_scores_reference(mu[r:r + 1], std[r:r + 1], cb[pair])[0]
        assert abs(s[0] - s[1]) <= NEAR_TIE * max(1.0, abs(s[1])), (r, pair, s)

    # the same indices decode alike; dequant is decode of the looked-up zhat
    deq_j = np.asarray(jeng.dequant(jnp.asarray(idx_j)))
    deq_p = peng.dequant(torch.from_numpy(idx_j))
    np.testing.assert_allclose(deq_p.numpy(), deq_j, atol=FP32_TOL, rtol=FP32_TOL)
    dec_p = peng.decode(torch.from_numpy(np.array(zhat_j)))
    np.testing.assert_array_equal(dec_p.numpy(), deq_p.numpy())
    assert torch.equal(peng.dequant(info_p["indices"]), peng.decode(zhat_p))


def test_bf16_slice_matches_jax(bf16_engines, image):
    """The port's bf16 CPU run walks the fused structure (resample stats
    handoff, deferred residual add) with the plain versions; the JAX engine
    at bf16 on the CPU takes its plain XLA path."""
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


def test_bf16_path_takes_the_fused_structure(bf16_engines):
    """At bf16 the resamples go through the fused ops (stats out, deferred add
    in) on any device; at float32 they take plain convs."""
    _, peng = bf16_engines
    enc, dec = peng.encoder, peng.decoder
    assert enc.down[0].downsample.fused and not enc.down[0].use_attn
    x = torch.randn((1, 32, 32, 32), dtype=torch.bfloat16).permute(0, 3, 1, 2)
    y, stats = enc.down[0](x)
    assert stats is not None and stats.shape == (1, 2, 32)
    h, stats_up = dec.up[1](torch.randn((1, 64, 16, 16), dtype=torch.bfloat16))
    assert h.shape == (1, 64, 32, 32) and stats_up.shape == (1, 2, 64)


def test_weights_round_trip_through_jax_converter(image):
    """A port state_dict loads into the JAX engine through the JAX package's
    own converter, strictly, and gives back the same parameters."""
    jeng, peng = _engines("float32", ["model.params.latent_stats=true"])
    sd = {k: v.numpy() for k, v in peng.state_dict().items()}
    prefix_map = {"encoder.": "encoder.", "decoder.": "decoder.",
                  "regularization.": "regularization.", "latent_mean": "latent_mean",
                  "latent_std": "latent_std"}
    params, missing, unexpected = convert_state_dict(sd, jeng.params, prefix_map=prefix_map,
                                                     strict=True)
    assert missing == [] and unexpected == []
    flat_in = jax.tree_util.tree_leaves_with_path(jeng.params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_out[path]), np.asarray(leaf))
    assert peng.module.latent_mean.shape == (1, 16, 1, 1)


def test_checkpoint_loads_pit_lightning_layout(fp32_engines, image, tmp_path):
    _, peng = fp32_engines
    sd = {k: v.clone() for k, v in peng.state_dict().items()}
    sd["loss.logvar"] = torch.zeros(())  # a training-only key the loader drops
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": sd}, path)
    cfg, _ = _configs("float32")
    fresh = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu", seed=1)
    x = torch.from_numpy(image)
    assert not torch.equal(fresh.encode(x, unregularized=True)[0],
                           peng.encode(x, unregularized=True)[0])
    missing, unexpected = fresh.load_checkpoint(str(path))
    assert missing == [] and unexpected == []
    assert torch.equal(fresh.encode(x, unregularized=True)[0], peng.encode(x, unregularized=True)[0])


def test_engine_api_shapes(fp32_engines, image):
    _, peng = fp32_engines
    x = torch.from_numpy(image)
    z, idx = peng.quant(x)
    assert z.shape == (2, 16, 16, 16) and idx.shape == (2, 16, 16, 1)
    z2, xrec, reg = peng(x, eps=torch.zeros((2, 256, 16)))
    assert torch.equal(z2, z) and xrec.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(reg["zhat_noquant"].numpy(),
                                  peng.encode(x, unregularized=True)[0][..., :16].numpy())
    dec = peng.decoder
    with torch.inference_mode():
        assert torch.equal(dec.last_layer(dec.pre_last_layer(z)), dec(z))


def test_config_targets_resolve_onto_the_port():
    for spelling in ("vqvae_from_gaussian_vae_tpu.models.unet.Encoder", "pit.modules.unet.Encoder"):
        assert resolve_target(spelling) == "vqvae_from_gaussian_vae_tpu_torch.models.unet.Encoder"
    for spelling in ("vqvae_from_gaussian_vae_tpu.losses.discriminator_loss."
                     "GeneralLPIPSWithDiscriminator",
                     "pit.modules.losses.discriminator_loss.GeneralLPIPSWithDiscriminator"):
        assert resolve_target(spelling) == ("vqvae_from_gaussian_vae_tpu_torch.losses."
                                            "discriminator_loss.GeneralLPIPSWithDiscriminator")
    for spelling in ("vqvae_from_gaussian_vae_tpu.data.dataset.ImageDataModuleFromConfig",
                     "pit.data.ImageDataModuleFromConfig"):
        assert resolve_target(spelling) == ("vqvae_from_gaussian_vae_tpu_torch.data.dataset."
                                            "ImageDataModuleFromConfig")
    target = "vqvae_from_gaussian_vae_tpu.data.video.VideoDataset"
    assert resolve_target(target) == "vqvae_from_gaussian_vae_tpu_torch.data.video.VideoDataset"
    with pytest.raises(TypeError, match="root"):  # the port's class, called without its root
        instantiate_from_config({"target": target, "params": {}})
    cfg = load_config(CONFIG, [t for t in TINY if "loss_config" not in t])
    eng = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu")
    assert type(eng.loss).__name__ == "GeneralLPIPSWithDiscriminator"
    eng = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu", eval_only=True)
    assert eng.encoder.dtype == torch.float32 and eng.loss is None


def test_engine_defaults_to_the_card():
    """Without device="cpu" the engine runs on the CUDA device, and raises
    where there is none."""
    cfg, _ = _configs("float32")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        instantiate_from_config(copy.deepcopy(cfg["model"]))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import vqvae_from_gaussian_vae_tpu_torch as p\n"
        "from vqvae_from_gaussian_vae_tpu_torch.models import autoencoder, unet\n"
        "from vqvae_from_gaussian_vae_tpu_torch.models import attention, hdit, postprocessor\n"
        "from vqvae_from_gaussian_vae_tpu_torch import serve\n"
        "from vqvae_from_gaussian_vae_tpu_torch.ops import _build, codebook, gq_search\n"
        "from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv, upsample_conv\n"
        "from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention, gq_cuda\n"
        "from vqvae_from_gaussian_vae_tpu_torch.utils import convert, flops\n"
        "cfg = p.load_config('configs/sd3unet_gq_0.25.yaml', ['model.params.loss_config=null'])\n"
        "p.instantiate_from_config(cfg['model']['params']['regularizer_config'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'vqvae_from_gaussian_vae_tpu'\n"
        "       or m.startswith('vqvae_from_gaussian_vae_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
