"""The port's FLUX pipeline, token-decoder engine and text conditioners
(``models/flux_pipeline.py``, ``models/conditioner.py``) against the JAX
package's.

FLUX at ``tests/test_flux.py``'s ``TINY`` width with a depth-1 ControlNet
and a reduced FLUX VAE (16 latent channels, f = 2) in place of the
published one; weights as in ``tests/test_torch_flux.py`` (random on the
JAX trees, bf16-valued, every layer nonzero).  Both sides get JAX's own
``get_noise(PRNGKey(42), ...)`` (the port through ``noise=``).  Bars:
3e-2 relative L2 for a 2-step ``denoise_controlnet`` with CFG from its
second step and for ``AutoencodingFluxEngine.dequant`` (a tiny UNet + GQ
tokenizer at f = 8, the pipeline at 2 steps).  The conditioners' contract
is held on tiny ``transformers`` torch models.
"""

import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_flux import JAX_TINY, TINY, flux_inputs, random_flux_tree, rel_l2
from tests.test_torch_hyvae import jax_diffusers_wrapper
from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models import flux as jflux
from vqvae_from_gaussian_vae_tpu.models import flux_pipeline as jpipe
from vqvae_from_gaussian_vae_tpu.utils.config import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.models import flux as pflux
from vqvae_from_gaussian_vae_tpu_torch.models import flux_pipeline as ppipe
from vqvae_from_gaussian_vae_tpu_torch.models import third_party as ptp
from vqvae_from_gaussian_vae_tpu_torch.models.conditioner import HFEmbedder
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

LOOP_REL_L2 = 3e-2
PKG = "vqvae_from_gaussian_vae_tpu"
AE = {"latent_channels": 16, "ch": 32, "ch_mult": [1, 2], "resolution": 32,
      "scaling_factor": 0.3611, "shift_factor": 0.1159}
UNET = {"attn_type": "vanilla", "double_z": True, "z_channels": 4, "resolution": 32,
        "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 1, 1, 1], "num_res_blocks": 1,
        "attn_resolutions": [], "dropout": 0.0}
ENGINE = {
    "target": f"{PKG}.models.flux_pipeline.AutoencodingFluxEngine",
    "params": {
        "input_key": "img", "num_steps": 2, "clamp_range": [-1, 1],
        "regularizer_config": {
            "target": f"{PKG}.quantization.gaussian.GaussianQuantRegularizer",
            "params": {"format": "bchw", "group": 4, "n_samples": 256, "seed": 7,
                       "backend": "xla"}},
        "encoder_config": {"target": f"{PKG}.models.unet.Encoder", "params": UNET},
        "decoder_config": {"target": f"{PKG}.models.unet.Decoder", "params": UNET},
    },
}


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) at TINY, control channels 4, a depth-1
    ControlNet, the reduced FLUX VAE, the same weights."""
    mp = pytest.MonkeyPatch()
    jae = jax_diffusers_wrapper(**AE, seed=20)
    pae = ptp.AutoencoderKLDiffusers(**AE, device="cpu")
    pae.model.load_state_dict(state_dict_from_jax(jae.params), strict=True)
    mp.setattr(jpipe, "AutoencoderKLFLUX", lambda **kw: jae)
    mp.setattr(ppipe, "AutoencoderKLFLUX", lambda **kw: pae)
    try:
        jp = jpipe.FluxPipeline(control_channels=4, flux_params=JAX_TINY, controlnet_depth=1)
        pp = ppipe.FluxPipeline(control_channels=4, flux_params=TINY, controlnet_depth=1,
                                device="cpu")
    finally:
        mp.undo()
    img, img_ids, txt, txt_ids, t, y, g = flux_inputs(b=1)
    jp.model_params = random_flux_tree(jp.model.init, img, img_ids, txt, txt_ids, t, y, None, g,
                                       seed=21)
    cond = np.zeros((1, 8, 8, 4), np.float32)
    jp.controlnet_params = random_flux_tree(jp.controlnet.init, img, img_ids, cond, txt, txt_ids,
                                            t, y, g, seed=22)
    pp.init_params()
    pp.model.load_state_dict(state_dict_from_jax(jp.model_params), strict=True)
    pp.controlnet.load_state_dict(state_dict_from_jax(jp.controlnet_params), strict=True)
    return jp, pp


def test_denoise_controlnet_matches_jax(pipelines):
    """Two steps, CFG from the second (true_gs 1.5, a different negative
    text): the port skips the first step's negative pass, JAX runs and
    discards it."""
    jp, pp = pipelines
    rng = np.random.default_rng(23)
    noise = np.asarray(jflux.get_noise(jax.random.PRNGKey(42), 1, 32, 32))
    img = np.asarray(jflux.pack_latents(jnp.asarray(noise)).astype(jnp.bfloat16), np.float32)
    img_ids = np.asarray(jflux.make_img_ids(4, 4, 1))
    txt, neg_txt = (rng.standard_normal((1, 8, TINY.context_in_dim)).astype(np.float32)
                    for _ in range(2))
    vec, neg_vec = (rng.standard_normal((1, TINY.vec_in_dim)).astype(np.float32)
                    for _ in range(2))
    cond = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    txt_ids = np.zeros((1, 8, 3), np.float32)
    ts = jflux.get_schedule(2, 4)
    kw = dict(timesteps=ts, guidance=4.0, true_gs=1.5, controlnet_gs=0.7,
              timestep_to_start_cfg=1)
    bf = jnp.bfloat16
    want = jflux.denoise_controlnet(
        lambda **k: jp.model.apply({"params": jp.model_params}, **k),
        lambda **k: jp.controlnet.apply({"params": jp.controlnet_params}, **k),
        jnp.asarray(img, bf), img_ids, jnp.asarray(txt, bf), txt_ids, jnp.asarray(vec, bf),
        jnp.asarray(neg_txt, bf), txt_ids, jnp.asarray(neg_vec, bf),
        controlnet_cond=jnp.asarray(cond, bf), **kw)
    t = lambda a: torch.from_numpy(np.asarray(a)).bfloat16()  # noqa: E731
    with torch.no_grad():
        got = pflux.denoise_controlnet(
            pp.model, pp.controlnet, t(img), torch.from_numpy(img_ids), t(txt),
            torch.from_numpy(txt_ids), t(vec), t(neg_txt), torch.from_numpy(txt_ids), t(neg_vec),
            controlnet_cond=t(cond), **kw)
    moved = np.asarray(want, np.float32) - img
    assert np.linalg.norm(moved) > 0.1 * np.linalg.norm(img)
    assert rel_l2(got.float() - torch.from_numpy(img), moved) <= LOOP_REL_L2


@pytest.fixture(scope="module")
def engines(pipelines):
    """(JAX engine, port engine): the same tokenizer weights (the port's
    seeded ones, through the JAX package's converter) and the pipelines."""
    jp, pp = pipelines
    peng = instantiate_from_config(copy.deepcopy(ENGINE), device="cpu")
    jeng = jax_instantiate(copy.deepcopy(ENGINE))
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda x: jeng.module.init({"params": key, "sample": key}, x,
                                                     train=False)["params"], x)
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)
    jeng.params, missing, unexpected = convert_state_dict(peng.state_dict(), template,
                                                          strict=True)
    assert missing == [] and unexpected == []
    jeng.xflux_pipeline, peng.xflux_pipeline = jp, pp
    return jeng, peng


def test_dequant_regenerates_as_jax(engines):
    """indices -> decode (for the size) -> the control latent (f = 8: no
    repeat) -> 2 pipeline steps from seed 42's noise -> the FLUX VAE -> the
    clamp, against the JAX engine."""
    jeng, peng = engines
    x = np.random.default_rng(24).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    _, indices = peng.quant(torch.from_numpy(x))
    assert tuple(indices.shape) == (1, 4, 4, 1)
    want = np.asarray(jeng.dequant(jnp.asarray(indices.numpy())), np.float32)
    noise = np.array(jflux.get_noise(jax.random.PRNGKey(42), 1, 32, 32))
    got = peng.dequant(indices, noise=torch.from_numpy(noise))
    assert tuple(got.shape) == want.shape == (1, 8, 8, 3)
    assert float(got.abs().max()) <= 1.0 and np.abs(want).max() > 0.05
    assert rel_l2(got, want) <= LOOP_REL_L2


def test_the_prompt_path(pipelines, monkeypatch):
    """prompt= needs both conditioners (ValueError, as the JAX pipeline);
    with them, the prompt's embeddings are what passing them as inputs
    gives."""
    _, pp = pipelines
    control = torch.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError, match="t5_path and clip_path"):
        pp(control, width=32, height=32, num_steps=1, txt_len=8, prompt="a cat")
    with pytest.raises(ValueError, match="ip_context_dim"):
        pp(control, width=32, height=32, num_steps=1, image_prompt_embeds=torch.zeros(1, 24))
    t5, clip = _tiny_encoders(monkeypatch, TINY.context_in_dim, TINY.vec_in_dim)
    pp.t5 = HFEmbedder(model=t5, tokenizer=_Tokenizer(), is_clip=False, max_length=8)
    pp.clip = HFEmbedder(model=clip, tokenizer=_Tokenizer(), is_clip=True, max_length=8)
    noise = pflux.get_noise(torch.Generator().manual_seed(1), 1, 32, 32)
    try:
        by_prompt = pp(control, width=32, height=32, num_steps=1, prompt="a cat", noise=noise)
        ids = _Tokenizer()(["a cat"], max_length=8)["input_ids"]
        neg = _Tokenizer()([""], max_length=8)["input_ids"]
        by_inputs = pp(control, width=32, height=32, num_steps=1, noise=noise,
                       inp_txt=pp.t5.embed_ids(ids), inp_vec=pp.clip.embed_ids(ids),
                       neg_inp_txt=pp.t5.embed_ids(neg), neg_inp_vec=pp.clip.embed_ids(neg))
    finally:
        pp.t5 = pp.clip = None
    assert torch.equal(by_prompt, by_inputs)


class _Tokenizer:
    """Characters -> ids, padded to max_length (the HF call's contract)."""

    def __call__(self, texts, max_length=8, **kwargs):
        ids = [[1 + ord(c) % 90 for c in t][:max_length] for t in texts]
        return {"input_ids": np.array([r + [0] * (max_length - len(r)) for r in ids])}


def _tiny_encoders(monkeypatch, t5_width=32, clip_width=16):
    """Tiny T5 encoder and CLIP text model; transformers is imported with its
    TensorFlow backend off (this test needs torch's only)."""
    monkeypatch.setenv("USE_TF", "0")
    from transformers import CLIPTextConfig, CLIPTextModel, T5Config, T5EncoderModel

    torch.manual_seed(0)
    t5 = T5EncoderModel(T5Config(vocab_size=100, d_model=t5_width, d_kv=8, d_ff=64,
                                 num_layers=2, num_heads=4))
    clip = CLIPTextModel(CLIPTextConfig(vocab_size=100, hidden_size=clip_width,
                                        intermediate_size=64, num_hidden_layers=2,
                                        num_attention_heads=4, max_position_embeddings=77))
    return t5, clip


def test_hf_embedder_contract(monkeypatch):
    """T5 gives its last_hidden_state, CLIP its pooler_output; without a
    tokenizer only ``embed_ids`` works; a checkpoint path without
    ``transformers`` raises an ImportError that says so."""
    t5, clip = _tiny_encoders(monkeypatch)
    ids = np.random.default_rng(25).integers(0, 100, (2, 8))
    t5_emb = HFEmbedder(model=t5, is_clip=False, max_length=8)
    clip_emb = HFEmbedder(model=clip, is_clip=True, max_length=8)
    seq, vec = t5_emb.embed_ids(ids), clip_emb.embed_ids(ids)
    assert tuple(seq.shape) == (2, 8, 32) and tuple(vec.shape) == (2, 16)
    with torch.no_grad():
        assert torch.equal(seq, t5(input_ids=torch.from_numpy(ids)).last_hidden_state)
        assert torch.equal(vec, clip(input_ids=torch.from_numpy(ids)).pooler_output)
    with pytest.raises(ValueError, match="embed_ids"):
        t5_emb(["no tokenizer injected"])
    with pytest.raises(ValueError, match="is_clip"):
        HFEmbedder(model=t5)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        HFEmbedder("/nonexistent/t5")


def test_lora_engine_builds_a_rank_128_pipeline(monkeypatch):
    """``AutoencodingFluxLoraEngine`` asks for flux-dev with rank-128 LoRA
    deltas and loads the LoRA file as flux's weights; the plain engine asks
    for none."""
    made = []

    class Recorder:
        def __init__(self, **kwargs):
            made.append(kwargs)

        def init_params(self):
            pass

    monkeypatch.setattr(ppipe, "FluxPipeline", Recorder)
    cfg = copy.deepcopy(ENGINE)
    cfg["target"] = f"{PKG}.models.flux_pipeline.AutoencodingFluxLoraEngine"
    cfg["params"]["lora_path"] = "lora.pt"
    instantiate_from_config(cfg, device="cpu").load_flux_pipeline()
    instantiate_from_config(copy.deepcopy(ENGINE), device="cpu").load_flux_pipeline()
    assert [(m["lora_rank"], m["flux_weights"], m["control_channels"]) for m in made] == \
        [(128, "lora.pt", 4), (0, None, 4)]
