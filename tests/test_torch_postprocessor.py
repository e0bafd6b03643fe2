"""The port's post engine (``models/postprocessor.py``) and its HDiT velocity
net (``models/hdit.py``) against the JAX package's.

HDiT: random parameters on the JAX model's ``jax.eval_shape`` tree, carried
into the port by ``state_dict_from_jax`` (strict): float32 within 1e-4; bf16
within 2e-2 at a bottleneck of L = 128 tokens, where both gates take the
flash path (the JAX kernel in interpret mode, the port's plain version).

The post engine: the tiny engine of ``tests/test_postprocessor.py``.  The
JAX engine gets the port autoencoder's seeded weights through its own
``convert_state_dict`` (strict) and random poster parameters that the port
loads by ``state_dict_from_jax`` (no JAX init is compiled).  ``post`` runs
4 Euler steps from the same noise (the JAX draw, injected into the port):
1e-4.  One train step with the JAX step's own t and noise draws: the loss
and the poster's gradient (taken from the JAX step by an optimizer that
hands its gradient back as its state) within 1e-4 relative L2.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models import hdit as jhdit
from vqvae_from_gaussian_vae_tpu.models import postprocessor as jpost
from vqvae_from_gaussian_vae_tpu.utils.config import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.models import hdit as phdit
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.utils.config import resolve_target
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

TOL = 1e-4
BF16_TOL = 2e-2
PKG = "vqvae_from_gaussian_vae_tpu"
UNET = {"attn_type": "vanilla", "double_z": True, "z_channels": 4, "resolution": 32,
        "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
        "attn_resolutions": [], "dropout": 0.0}
HDIT = {"patch_size": 4, "widths": [32, 64], "depths": [2, 1], "windows": [4, 0],
        "mapping_width": 32}
POST = {
    "target": f"{PKG}.models.postprocessor.AutoencodingPostEngine",
    "params": {
        "input_key": "img", "num_flow_steps": 4, "mmse_noise_std": 0.1, "clamp_range": [-1, 1],
        "post_config": {"target": f"{PKG}.models.hdit.create_hdit_model", "params": HDIT},
        "regularizer_config": {
            "target": f"{PKG}.quantization.gaussian.GaussianQuantRegularizer",
            "params": {"format": "bchw", "group": 4, "n_samples": 256, "seed": 7,
                       "backend": "xla"}},
        "encoder_config": {"target": f"{PKG}.models.unet.Encoder", "params": UNET},
        "decoder_config": {"target": f"{PKG}.models.unet.Decoder", "params": UNET},
    },
}


def _random_params(module, rng, *args, scale=0.2):
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        tree)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_hdit_forward_matches_jax_float32():
    """Two levels: shifted 4x4 windows on the 8x8 grid (block 1 shifts),
    global attention at the 4x4 bottleneck."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([0.1, 0.9], np.float32)
    jnet = jhdit.create_hdit_model(**HDIT)
    params = _random_params(jnet, rng, jnp.asarray(x), jnp.asarray(t))
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    pnet = phdit.create_hdit_model(**HDIT)
    pnet.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), torch.from_numpy(t))
        one_t = pnet(torch.from_numpy(x), torch.tensor([0.1])).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # a single t broadcasts over the batch, as in the JAX model
    np.testing.assert_allclose(one_t[0], got.numpy()[0], atol=TOL, rtol=TOL)


def test_hdit_forward_matches_jax_bf16_through_flash(monkeypatch):
    """bf16 at a 16x8 bottleneck (L = 128, two heads of 64): the port's gate
    sends it to flash, as the JAX gate does (interpret mode here); the
    level-0 windows (64 tokens) take the einsum path in both."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 128, 64, 3)).astype(np.float32)
    t = np.array([0.3], np.float32)
    cfg = {"patch_size": 4, "widths": [64, 128], "depths": [1, 1], "windows": [8, 0],
           "mapping_width": 32, "dtype": "bfloat16"}
    jnet = jhdit.create_hdit_model(**cfg)
    params = _random_params(jnet, rng, jnp.asarray(x), jnp.asarray(t), scale=0.1)
    monkeypatch.setenv("GVQ_FLASH_INTERPRET", "1")
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)),
                      np.float32)
    pnet = phdit.create_hdit_model(**cfg)
    pnet.load_state_dict(state_dict_from_jax(params), strict=True)
    calls = {"flash": 0, "sdpa": 0}
    real_flash, real_sdpa = fa.flash_attention, phdit.sdpa_token_major

    def flash(*args):
        calls["flash"] += 1
        return real_flash(*args)

    def sdpa(*args):
        calls["sdpa"] += 1
        return real_sdpa(*args)

    monkeypatch.setattr(fa, "flash_attention", flash)
    monkeypatch.setattr(phdit, "sdpa_token_major", sdpa)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert calls == {"flash": 1, "sdpa": 3}  # the mid block's; down, up in windows
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


# ---------------------------------------------------------------------------
# the post engine


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with the same autoencoder and poster weights."""
    peng = instantiate_from_config(copy.deepcopy(POST), device="cpu")
    jeng = jax_instantiate(copy.deepcopy(POST))
    rng = np.random.default_rng(2)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda x: jeng.ae.module.init({"params": key, "sample": key}, x,
                                                        train=False)["params"], x)
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)
    jeng.ae.params, missing, unexpected = convert_state_dict(peng.ae.state_dict(), template,
                                                             strict=True)
    assert missing == [] and unexpected == []
    # every poster parameter random, the zero-initialised heads too, so v != 0
    jeng.poster_params = _random_params(jeng.poster, rng, x, jnp.zeros((1,)), scale=0.1)
    peng.poster.load_state_dict(state_dict_from_jax(jeng.poster_params), strict=True)
    return jeng, peng


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


def test_post_matches_jax(engines, image):
    jeng, peng = engines
    xhat = np.clip(image + 0.1, -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jeng.post(jnp.asarray(xhat), rng=key))
    noise = np.array(jax.random.normal(key, xhat.shape))
    got = peng.post(torch.from_numpy(xhat), noise=torch.from_numpy(noise)).numpy()
    assert np.abs(got - np.clip(xhat + 0.1 * noise, -1, 1)).max() > 1e-2  # v moved it
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_train_step_loss_and_gradient_match_jax(engines, image, monkeypatch):
    jeng, peng = engines

    def grads_as_state(learning_rate):
        del learning_rate
        return optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))

    monkeypatch.setattr(jpost.optax, "adam", grads_as_state)
    step, state = jeng.make_train_step(1e-3)
    key = jax.random.PRNGKey(7)
    _, grads, loss_j = step(jeng.poster_params, state, jnp.asarray(image), key)
    _, r2, r3 = jax.random.split(key, 3)
    t = np.array(jax.random.uniform(r2, (2, 1, 1, 1))).reshape(2)
    noise = np.array(jax.random.normal(r3, image.shape))

    before = {k: v.clone() for k, v in peng.poster.state_dict().items()}
    ae_before = {k: v.clone() for k, v in peng.ae.state_dict().items()}
    train_step, opt = peng.make_train_step(1e-3)
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["eps"] == 1e-8
    loss_p = train_step(torch.from_numpy(image), t=torch.from_numpy(t),
                        noise=torch.from_numpy(noise))
    assert abs(float(loss_p) - float(loss_j)) <= TOL * abs(float(loss_j))
    want = state_dict_from_jax(grads)
    got = {n: p.grad for n, p in peng.poster.named_parameters()}
    assert set(got) == set(want)
    assert got["FourierFeatures_0.freqs"] is None  # stop_gradient in both
    assert float(np.abs(want["FourierFeatures_0.freqs"].numpy()).max()) == 0.0
    names = sorted(n for n in got if got[n] is not None)
    g = np.concatenate([got[n].numpy().ravel() for n in names])
    w = np.concatenate([want[n].numpy().ravel() for n in names])
    assert _rel_l2(g, w) <= TOL
    # the poster moved; the autoencoder stayed frozen
    after = peng.poster.state_dict()
    assert not torch.equal(after["mid_block_0.qkv.weight"], before["mid_block_0.qkv.weight"])
    assert all(torch.equal(v, ae_before[k]) for k, v in peng.ae.state_dict().items())
    peng.poster.load_state_dict(before)


def test_eval_only_refuses_to_train():
    cfg = copy.deepcopy(POST)
    cfg["params"]["eval_only"] = True
    peng = instantiate_from_config(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="eval_only"):
        peng.make_train_step(1e-3)
    jeng = jax_instantiate(cfg)
    with pytest.raises(RuntimeError, match="eval_only"):
        jeng.make_train_step(1e-3)


def test_engine_api_and_log_images(engines, image):
    _, peng = engines
    x = torch.from_numpy(image)
    z, reg = peng.encode(x, return_reg_log=True)
    xhat = peng.decode(z)
    assert xhat.shape == x.shape
    assert torch.equal(peng.dequant(reg["indices"]), torch.clamp(xhat, -1, 1))
    assert torch.equal(peng.quant(x)[1], reg["indices"])
    logs = peng.log_images({"img": x})
    assert set(logs) == {"inputs", "xhat", "xhat_post"}
    assert float(logs["xhat_post"].abs().max()) <= 1.0
    a = peng.post(xhat, generator=torch.Generator().manual_seed(1))
    b = peng.post(xhat, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_fresh_poster_returns_zero_velocity():
    """Seeded weights keep the JAX model's zero-initialised heads."""
    net = phdit.create_hdit_model(**HDIT)
    phdit.init_hdit_weights(net, 0)
    with torch.no_grad():
        v = net(torch.randn(2, 32, 32, 3), torch.tensor([0.1, 0.9]))
    assert v.shape == (2, 32, 32, 3) and float(v.abs().max()) == 0.0
    full = phdit.create_hdit_model()  # the defaults: heads width // 64, windows (8, 0)
    assert (full.down_0_block_1.heads, full.down_0_block_1.shift, full.mid_block_3.heads,
            full.mid_block_3.window) == (2, True, 4, 0)


@pytest.mark.parametrize("target", [
    "vqvae_from_gaussian_vae_tpu.models.postprocessor.AutoencodingPostEngine",
    "pit.models.postprocessor.AutoencodingPostEngine",
    "vqvae_from_gaussian_vae_tpu.models.hdit.create_hdit_model",
    "pit.modules.hdit.create_hdit_model"])
def test_registry_spellings(target):
    leaf = target.rsplit(".", 2)
    assert resolve_target(target) == \
        f"vqvae_from_gaussian_vae_tpu_torch.models.{leaf[1]}.{leaf[2]}"
