"""The port's HunyuanVAE2D (``models/hyvae.py``) and frozen baseline VAEs
(``models/third_party.py``) against the JAX package's, and the port's
``eval.py`` on a baseline in protocol mode.

Random parameters on the JAX modules' ``jax.eval_shape`` trees (no JAX init
is compiled) are carried into the port by ``state_dict_from_jax``
(strict); the same numpy inputs go through both, float32, within 1e-4.
The posterior's noise is the JAX wrapper's own draw (its key split as the
wrapper splits it), injected into the port as ``eps``.  The HunyuanImage
wrappers are held at reduced widths (their published widths are checked
as constructor arguments, read from the JAX classes with their backbone
replaced by a recorder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models import hyvae as jhy
from vqvae_from_gaussian_vae_tpu.models import third_party as jtp
from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.evaluations import inception, lpips_metric
from vqvae_from_gaussian_vae_tpu_torch.models import hyvae as phy
from vqvae_from_gaussian_vae_tpu_torch.models import third_party as ptp
from vqvae_from_gaussian_vae_tpu_torch.utils.config import resolve_target
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

TOL = 1e-4
TINY_HY = {"block_out_channels": [32, 64], "latent_channels": 4, "layers_per_block": 1,
           "ffactor_spatial": 2, "sample_size": 16}
TINY_KL = {"latent_channels": 4, "ch": 32, "ch_mult": [1, 2], "resolution": 32,
           "scaling_factor": 0.5, "shift_factor": 0.1}


def _random_tree(init, *args, scale=0.2, seed=0):
    tree = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def hy_pair():
    """(JAX HunyuanVAE2D, port HunyuanVAE2D) with the same random weights."""
    jvae = jhy.HunyuanVAE2D(**TINY_HY)
    x = jnp.zeros((1, 16, 16, 3))
    z = jnp.zeros((1, 8, 8, 4))
    jvae.params = {"encoder": _random_tree(jvae.encoder.init, x, seed=1),
                   "decoder": _random_tree(jvae.decoder.init, z, seed=2)}
    pvae = phy.HunyuanVAE2D(**TINY_HY, device="cpu")
    pvae.load_state_dict(state_dict_from_jax(jvae.params), strict=True)
    return jvae, pvae


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)


def test_diagonal_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    params = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    other = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    sample = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    jd, jo = jhy.DiagonalGaussianDistribution(jnp.asarray(params)), \
        jhy.DiagonalGaussianDistribution(jnp.asarray(other))
    pd, po = phy.DiagonalGaussianDistribution(torch.from_numpy(params)), \
        phy.DiagonalGaussianDistribution(torch.from_numpy(other))
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (2, 4, 4, 4)))
    _close(pd.kl(), jd.kl())
    _close(pd.kl(po), jd.kl(jo))
    _close(pd.nll(torch.from_numpy(sample)), jd.nll(jnp.asarray(sample)))
    assert torch.equal(pd.mode(), torch.from_numpy(params[..., :4]))
    _close(pd.sample(eps=torch.from_numpy(eps)), jd.sample(key))
    det = phy.DiagonalGaussianDistribution(torch.from_numpy(params), deterministic=True)
    assert float(det.kl().abs().max()) == 0.0 and torch.equal(det.std, torch.zeros(2, 4, 4, 4))


@pytest.mark.parametrize("kind", ["down", "up"])
def test_residual_resamplers_match_jax(kind):
    """conv + pixel-(un)shuffle with the grouped-mean / repeat shortcut."""
    rng = np.random.default_rng(5)
    if kind == "down":
        jmod, pmod = jhy.Downsample(32, 64), phy.Downsample(32, 64)
        x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    else:
        jmod, pmod = jhy.Upsample(64, 32), phy.Upsample(64, 32)
        x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    params = _random_tree(jmod.init, jnp.asarray(x))
    pmod.load_state_dict(state_dict_from_jax(params), strict=True)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)


def test_hunyuan_vae_matches_jax(hy_pair, images):
    """Moments, mode -> decode, the sampled forward with the JAX draw, and
    slicing (a batch one image at a time) against the JAX model's."""
    jvae, pvae = hy_pair
    x = jnp.asarray(images)
    jpost = jvae.encode(x)
    with torch.no_grad():
        ppost = pvae.encode(torch.from_numpy(images))
        _close(ppost.parameters, jpost.parameters)
        _close(ppost.logvar, jpost.logvar)
        want = np.asarray(jvae.decode(jpost.mode()))
        got = pvae.decode(ppost.mode())
        _close(got, want)
        key = jax.random.PRNGKey(6)
        _, sub = jax.random.split(key)
        eps = np.asarray(jax.random.normal(sub, jpost.mean.shape))
        _close(pvae(torch.from_numpy(images), sample_posterior=True, eps=torch.from_numpy(eps)),
               jvae(x, rng=key, sample_posterior=True))
        jvae.use_slicing = pvae.use_slicing = True
        try:
            _close(pvae.decode(ppost.mode()), jvae.decode(jpost.mode()))
            _close(pvae.encode(torch.from_numpy(images)).parameters, jvae.encode(x).parameters)
        finally:
            jvae.use_slicing = pvae.use_slicing = False


def test_blends_match_jax_and_tiling_is_off_by_default(hy_pair):
    """``blend_h`` / ``blend_v`` against the JAX model's; tiling is off
    unless asked for, a tile that covers the image changes nothing, and
    smaller tiles still give the image's shape."""
    jvae, pvae = hy_pair
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((1, 6, 7, 3)).astype(np.float32) for _ in range(2))
    for extent in (2, 5, 9):
        _close(pvae.blend_h(torch.from_numpy(a), torch.from_numpy(b), extent),
               jvae.blend_h(jnp.asarray(a), jnp.asarray(b), extent))
        _close(pvae.blend_v(torch.from_numpy(a), torch.from_numpy(b), extent),
               jvae.blend_v(jnp.asarray(a), jnp.asarray(b), extent))
    assert pvae.use_spatial_tiling is False
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        plain = pvae.encode(x).parameters
        z = plain[..., :4]
        dec = pvae.decode(z)
        pvae.use_spatial_tiling = True
        try:
            pvae.tile_sample_min_size, pvae.tile_latent_min_size = 32, 16
            assert torch.equal(pvae.encode(x).parameters, plain)
            pvae.tile_sample_min_size, pvae.tile_latent_min_size = 16, 8
            tiled = pvae.encode(x).parameters
            tiled_dec = pvae.decode(z)
        finally:
            pvae.use_spatial_tiling = False
            pvae.tile_sample_min_size, pvae.tile_latent_min_size = 16, 8
    assert tiled.shape == plain.shape and tiled_dec.shape == dec.shape
    assert bool(torch.isfinite(tiled).all()) and bool(torch.isfinite(tiled_dec).all())


def jax_diffusers_wrapper(latent_channels, ch, ch_mult, resolution, scaling_factor,
                          shift_factor, seed=9):
    """The JAX wrapper without its constructor's eager init: the
    constructor's fields, its jitted encode and decode, random weights."""
    from vqvae_from_gaussian_vae_tpu.models.unet import Decoder, Encoder

    jw = jtp.AutoencoderKLDiffusers.__new__(jtp.AutoencoderKLDiffusers)
    jtp._FrozenVAEBase.__init__(jw, 0)
    jw.scaling_factor, jw.shift_factor = scaling_factor, shift_factor
    common = dict(attn_type="vanilla", z_channels=latent_channels, resolution=resolution,
                  in_channels=3, out_ch=3, ch=ch, ch_mult=list(ch_mult), num_res_blocks=2,
                  attn_resolutions=[], dropout=0.0)
    jw.encoder, jw.decoder = Encoder(double_z=True, **common), Decoder(double_z=True, **common)
    f = 2 ** (len(ch_mult) - 1)
    jw.params = {
        "encoder": _random_tree(jw.encoder.init, jnp.zeros((1, 32, 32, 3)), seed=seed),
        "decoder": _random_tree(jw.decoder.init, jnp.zeros((1, 32 // f, 32 // f,
                                                            latent_channels)), seed=seed + 1)}
    jw._enc = jax.jit(lambda p, x: jw.encoder.apply({"params": p["encoder"]}, x))
    jw._dec = jax.jit(lambda p, z: jw.decoder.apply({"params": p["decoder"]}, z))
    return jw


def test_diffusers_wrapper_matches_jax(images):
    """AutoencoderKLDiffusers (the FLUX / SD3 / EQ layout) at reduced width:
    encode with the JAX wrapper's first draw, the shift and scale, decode."""
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jw = jax_diffusers_wrapper(**TINY_KL)
    pw = ptp.AutoencoderKLDiffusers(**TINY_KL, device="cpu")
    pw.model.load_state_dict(state_dict_from_jax(jw.params), strict=True)
    _, sub = jax.random.split(jw._rng)
    moments = np.asarray(jw._enc(jw.params, jnp.asarray(x)))
    eps = np.asarray(jax.random.normal(sub, moments[..., :4].shape))
    jz, jlog = jw.encode(jnp.asarray(x))
    pz, plog = pw.encode(torch.from_numpy(x), eps=torch.from_numpy(eps))
    assert jlog == plog == {}
    _close(pz, jz)
    _close(pw.decode(pz), jw.decode(jz))
    # without eps the port draws from its seeded generator: same shape, new noise
    pz2, _ = pw.encode(torch.from_numpy(x))
    assert pz2.shape == pz.shape and not torch.equal(pz2, pz)


class _TinyHY2(ptp.AutoencoderKLHYImage2):
    CONFIG = {**ptp.AutoencoderKLHYImage2.CONFIG, "block_out_channels": [32, 64],
              "latent_channels": 4, "ffactor_spatial": 2}


def test_hunyuan_wrapper_matches_jax():
    """The HunyuanImage wrappers' protocol (raw posterior samples, no shift
    or scale) at reduced width against a JAX wrapper over the same model."""
    x = np.random.default_rng(11).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    jvae = jhy.HunyuanVAE2D(block_out_channels=[32, 64], latent_channels=4,
                            layers_per_block=2, ffactor_spatial=2)
    jvae.params = {"encoder": _random_tree(jvae.encoder.init, jnp.zeros((1, 16, 16, 3)), seed=12),
                   "decoder": _random_tree(jvae.decoder.init, jnp.zeros((1, 8, 8, 4)), seed=13)}
    jw = jtp.AutoencoderKLHYImage2.__new__(jtp.AutoencoderKLHYImage2)
    jtp._FrozenVAEBase.__init__(jw, 0)
    jw.model = jvae
    pw = _TinyHY2(device="cpu")
    pw.model.load_state_dict(state_dict_from_jax(jvae.params), strict=True)
    _, sub = jax.random.split(jw._rng)
    eps = np.asarray(jax.random.normal(sub, (1, 8, 8, 4)))
    jz, _ = jw.encode(jnp.asarray(x))
    pz, plog = pw.encode(torch.from_numpy(x), eps=torch.from_numpy(eps))
    assert plog == {}
    _close(pz, jz)
    _close(pw.decode(pz), jw.decode(jz))


def test_published_widths_are_the_jax_wrappers(monkeypatch):
    """Each wrapper's constructor arguments, read from the JAX class with its
    backbone replaced by a recorder, against the port's."""
    seen = {}

    class Recorder:
        def __init__(self, **kwargs):
            seen["hy"] = kwargs

        def init_params(self, **kwargs):
            pass

    def record_kl(self, **kwargs):
        seen["kl"] = kwargs

    monkeypatch.setattr(jtp, "HunyuanVAE2D", Recorder)
    monkeypatch.setattr(jtp.AutoencoderKLDiffusers, "__init__", record_kl)
    for name in ("AutoencoderKLHYImage2", "AutoencoderKLHYImage3"):
        getattr(jtp, name)(ckpt_path=None)
        want = {k: seen["hy"][k] for k in ("block_out_channels", "latent_channels",
                                            "ffactor_spatial", "scaling_factor")}
        assert getattr(ptp, name).CONFIG == want
        assert seen["hy"]["layers_per_block"] == 2 and seen["hy"]["sample_size"] == 384
    published = {"AutoencoderKLFLUX": (16, 0.3611, 0.1159), "AutoencoderKLSD3": (16, 1.5305, 0.0609),
                 "AutoencoderKLEQ": (4, None, None)}
    for name, (channels, scaling, shift) in published.items():
        getattr(jtp, name)()
        kw = seen["kl"]
        assert (kw["latent_channels"], kw.get("scaling_factor"), kw.get("shift_factor")) == (
            channels, scaling, shift)
    flux = ptp.AutoencoderKLFLUX(device="cpu")
    assert (flux.scaling_factor, flux.shift_factor) == (0.3611, 0.1159)
    assert flux.model.encoder.conv_out.out_channels == 32  # double_z over 16 channels
    assert len(flux.model.decoder.up) == 4  # ch_mult (1, 2, 4, 4): f = 8


@pytest.mark.parametrize("name", ["AutoencoderKLQwenImage", "AutoencoderKLWAN"])
def test_wan_wrappers_name_what_is_missing(name):
    with pytest.raises(NotImplementedError, match="WAN"):
        getattr(ptp, name)(device="cpu")
    with pytest.raises(NotImplementedError, match="WAN"):
        instantiate_from_config({"target": f"pit.models.autoencoder.{name}",
                                 "params": {"device": "cpu"}})


def test_baseline_targets_resolve_onto_the_port():
    for cls in ("AutoencoderKLFLUX", "AutoencoderKLSD3", "AutoencoderKLEQ",
                "AutoencoderKLHYImage2", "AutoencoderKLHYImage3", "AutoencoderKLQwenImage",
                "AutoencoderKLWAN"):
        want = f"vqvae_from_gaussian_vae_tpu_torch.models.third_party.{cls}"
        assert resolve_target(f"pit.models.autoencoder.{cls}") == want
        assert resolve_target(f"vqvae_from_gaussian_vae_tpu.models.third_party.{cls}") == want
    assert resolve_target("pit.models.hyvae.HunyuanVAE2D") == \
        "vqvae_from_gaussian_vae_tpu_torch.models.hyvae.HunyuanVAE2D"
    vae = instantiate_from_config({"target": "pit.models.hyvae.HunyuanVAE2D",
                                   "params": {**TINY_HY, "device": "cpu"}})
    assert isinstance(vae, phy.HunyuanVAE2D) and vae.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="AutoencoderKLWan"):
        resolve_target("vqvae_from_gaussian_vae_tpu.models.wan.AutoencoderKLWan")


class _FeatureStandIn(torch.nn.Module):
    """(B, 1, 1, 3) features: each image's channel means (a small FID)."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, img):
        return (img.float().mean((1, 2))[:, None, None, :],)


def test_eval_protocol_mode_on_a_baseline(tmp_path, monkeypatch):
    """The port's ``eval.py`` on a wrapper (no ``.module``, no indices): the
    per-image PSNR equals the wrapper's own reconstruction's, no codebook
    histogram."""
    from PIL import Image

    from vqvae_from_gaussian_vae_tpu_torch.evaluations.psnr import get_psnr

    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(14)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
            folder / f"{i}.png")
    cfg = {"model": {"target": "vqvae_from_gaussian_vae_tpu.models.third_party."
                               "AutoencoderKLDiffusers", "params": dict(TINY_KL)}}
    base = tmp_path / "baseline.yaml"
    base.write_text(yaml.safe_dump(cfg))
    # the metric nets' own tests are elsewhere: cheap stand-ins here
    monkeypatch.setattr(inception, "InceptionV3", _FeatureStandIn)
    monkeypatch.setattr(lpips_metric, "LPIPSMetric",
                        lambda *a, **k: (lambda x, y: (x - y).abs().mean((1, 2, 3))))
    res = port_eval.main(["--base", str(base), "--dataset", str(folder), "--img_size", "32",
                          "--bs", "2", "--device", "cpu"])
    assert res["count"] == 4 and res["hist"].sum() == 0 and "usage" not in res
    assert np.isfinite(res["psnr"]).all() and np.isfinite(res["lpips"]).all()
    from vqvae_from_gaussian_vae_tpu_torch.data.dataset import SimpleDataset

    wrapper = ptp.AutoencoderKLDiffusers(**TINY_KL, device="cpu")
    data = SimpleDataset(str(folder), image_size=32)
    want = []
    for i in range(0, 4, 2):
        img = torch.as_tensor(np.stack([data[j]["img"] for j in (i, i + 1)]))
        z, _ = wrapper.encode(img)
        want.append(get_psnr(img, wrapper.decode(z).float(), zero_mean=True).numpy())
    np.testing.assert_allclose(res["psnr"], np.concatenate(want), rtol=TOL)
