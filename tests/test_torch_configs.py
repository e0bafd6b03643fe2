"""Every config in ``configs/`` builds in the port, at small overrides, with
the JAX engine's parameters: the port's state_dict keys are exactly the
keys ``state_dict_from_jax`` gives the JAX engine's parameter tree (taken
by ``jax.eval_shape``, so no JAX init is compiled).  Each port engine then
encodes a small batch, and where its regularizer gives indices,
``dequant(indices)`` is ``decode`` of the quantized latent.  The VQ
engine's checkpoint carries its codebook (``regularization.embedding.weight``)
through ``load_checkpoint``.
"""

import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.models import foundation as jfnd
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
from vqvae_from_gaussian_vae_tpu_torch.models import foundation as pfnd
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))
OVERLAY = "configs/overlays/bf16_compute.yaml"
SMALL_TRUNK = (14, 64, 2, 4, 1e-5)
RES = 56  # a 4 x 4 grid of the trunk's 14-pixel patches
UNET = {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [28],
        "resolution": RES}
VIT = {"width": 64, "layers": 2, "heads": 2, "image_size": 32}


def _small(bases):
    cfg = load_config([os.path.join(REPO, b) for b in bases])
    p = cfg["model"]["params"]
    unet = "unet" in p["encoder_config"]["target"]
    p["encoder_config"]["params"].update(UNET if unet else VIT)
    p["decoder_config"]["params"] = copy.deepcopy(p["encoder_config"]["params"])
    p.pop("ckpt_path", None)
    p["loss_config"]["params"]["discriminator_config"]["params"].update(ndf=8, n_layers=2)
    return cfg, (RES if unet else VIT["image_size"])


@pytest.fixture(autouse=True)
def small_trunk(monkeypatch):
    monkeypatch.setitem(jfnd._SPECS, "dinov2", SMALL_TRUNK)
    monkeypatch.setitem(pfnd._SPECS, "dinov2", SMALL_TRUNK)


def _jax_keys(cfg, res):
    jeng = jax_instantiate(copy.deepcopy(cfg["model"]))
    x = jnp.zeros((1, res, res, 3), jnp.float32)
    rng = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda x: jeng.module.init({"params": rng, "sample": rng}, x,
                                                     train=False)["params"], x)
    return set(state_dict_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)))


def test_every_config_is_covered():
    assert len(CONFIGS) == 15
    assert all(os.path.exists(os.path.join(REPO, c)) for c in CONFIGS + [OVERLAY])


@pytest.mark.parametrize("bases", [[c] for c in CONFIGS] + [[CONFIGS[-1], OVERLAY]],
                         ids=[os.path.basename(c) for c in CONFIGS] + ["sd3unet_vq_16+bf16"])
def test_config_builds_in_the_port_with_the_jax_keys(bases):
    cfg, res = _small(bases)
    engine = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu")
    keys = set(engine.state_dict())
    assert keys == _jax_keys(cfg, res)
    assert engine.load_state_dict(engine.state_dict(), strict=True)
    x = torch.rand((2, res, res, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    z, xrec, reg = engine.forward(x)
    assert xrec.shape == x.shape and bool(torch.isfinite(xrec.float()).all())
    if "indices" in reg:
        torch.testing.assert_close(engine.regularization.dequant(reg["indices"]), z.float(),
                                   rtol=0, atol=1e-6)
        xhat = engine.dequant(reg["indices"])
        want = engine.module._clamp(engine.decode(z))
        torch.testing.assert_close(xhat.float(), want.float(), rtol=0, atol=2e-2)
    if engine.use_vf:
        assert reg["zp"].shape[:3] == reg["aux_feature"].shape[:3] == (2, 4, 4)
        assert not any(p.requires_grad for p in engine.module.foundation.parameters())


def test_vq_checkpoint_keeps_its_codebook(tmp_path):
    cfg, res = _small(["configs/sd3unet_vq_16.yaml"])
    a = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu", seed=1)
    b = instantiate_from_config(copy.deepcopy(cfg["model"]), device="cpu", seed=2)
    key = "regularization.embedding.weight"
    w = a.state_dict()[key]
    assert w.shape == (65536, 16) and float(w.abs().max()) <= 1.0 / 65536
    assert not torch.equal(w, b.state_dict()[key])
    a.save_params(str(tmp_path / "vq.pt"))
    missing, unexpected = b.load_checkpoint(str(tmp_path / "vq.pt"))
    assert missing == [] and unexpected == []
    assert torch.equal(b.state_dict()[key], w)
    x = torch.rand((1, res, res, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1
    assert torch.equal(a.quant(x)[1], b.quant(x)[1])


def test_eval_sweep_runs_a_regularizer_without_indices(tmp_path, monkeypatch, capsys):
    """The port's ``eval.py`` on the plain Gaussian config (no indices):
    the metrics come out and the codebook histogram is skipped, as the JAX
    sweep skips it.  FID's 2048-d matrix square root is stubbed: its value
    is not what this holds."""
    import yaml
    from PIL import Image

    from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
    from vqvae_from_gaussian_vae_tpu_torch.evaluations import fid

    cfg, res = _small(["configs/sd3unet_gaussian_kl_0.64.yaml"])
    cfg["model"]["params"]["encoder_config"]["params"]["resolution"] = 32
    cfg["model"]["params"]["decoder_config"]["params"]["resolution"] = 32
    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"{i}.png")
    with open(tmp_path / "gauss.yaml", "w") as f:
        yaml.safe_dump({"model": cfg["model"]}, f)
    monkeypatch.setattr(fid, "calculate_frechet_distance", lambda *a: 0.0)
    result = port_eval.main(["--base", str(tmp_path / "gauss.yaml"), "--dataset",
                             str(tmp_path / "images"), "--img_size", "32", "--bs", "2",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert result["count"] == 4 and np.isfinite(result["psnr"]).all()
    assert "usage" not in result and "codebook usage" not in out
    assert int(result["hist"].sum()) == 0
