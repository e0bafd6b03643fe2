"""The port's WAN video VAE (``models/wan.py``) and its Qwen-Image and WAN
wrappers against the JAX package's, on the CPU in float32.

The small configs are ``tests/test_wan.py``'s: ``CFG`` (one temporal stage)
and ``CFG2`` (two, so that the decoder's second temporal upsample sees
two-frame chunks).  The port's seeded ``state_dict`` goes into the JAX
model through the JAX package's own ``convert_state_dict`` (no missing and
no unexpected key, the ``time_conv`` weights included), onto templates
that ``jax.eval_shape`` makes, so that no JAX init is compiled; the JAX tree
comes back through ``state_dict_from_jax`` equal.  The same numpy clips go
through both: the whole-clip path (one frame, five frames) and the chunked
streaming path (T = 5 and 9 frames in; 2 and 3 latent frames in, up to 9
frames out), within the JAX tests' 2e-4.  The wrappers' posterior sample takes an injected ``eps``.
"""

import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models import third_party as jtp
from vqvae_from_gaussian_vae_tpu.models.wan import AutoencoderKLWan as JaxWan
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch.models import third_party as ptp
from vqvae_from_gaussian_vae_tpu_torch.models.wan import AutoencoderKLWan
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

TOL = 2e-4  # tests/test_wan.py's bar
CFG = dict(base_dim=24, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
           temperal_downsample=(False, True))
CFG2 = dict(base_dim=16, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
            temperal_downsample=(True, True))
WRAPPED = dict(base_dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
               temperal_downsample=(False,))


@contextlib.contextmanager
def shape_only_init():
    """flax ``init`` as zero arrays of ``jax.eval_shape``'s shapes: the JAX
    constructors trace their modules but compile nothing."""
    real = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda: real(self, rngs, *args, **kwargs))
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = real


def _carry(port_sd, template):
    params, missing, unexpected = convert_state_dict(port_sd, template)
    assert missing == [] and unexpected == [], (missing, unexpected)
    return params


def _pair(cfg, seed):
    port = AutoencoderKLWan(**cfg, seed=seed, device="cpu")
    with shape_only_init():
        jax_model = JaxWan(**cfg)
    jax_model.params = _carry(port.state_dict(), jax_model.params)
    return port, jax_model


@pytest.fixture(scope="module")
def pairs():
    return {"CFG": _pair(CFG, 3), "CFG2": _pair(CFG2, 4)}


def _clip(seed, t, size=16):
    return np.random.default_rng(seed).standard_normal((1, t, size, size, 3)).astype(
        np.float32) * 0.5


def _latent(seed, t, z=4, size=4):
    return np.random.default_rng(seed).standard_normal((1, t, size, size, z)).astype(np.float32)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["CFG", "CFG2"])
def test_state_dicts_cross_both_ways(pairs, name):
    port, jax_model = pairs[name]
    own = port.state_dict()
    assert any(".time_conv." in k for k in own)
    back = state_dict_from_jax(jax_model.params)
    assert back.keys() == own.keys()
    assert all(torch.equal(back[k], own[k]) for k in own)


def test_whole_clip_single_frame_encode_matches_jax(pairs):
    port, jax_model = pairs["CFG"]
    x = np.random.default_rng(0).standard_normal((2, 1, 32, 32, 3)).astype(np.float32) * 0.5
    got = port.encode(torch.from_numpy(x))
    _close(got.parameters, jax_model._enc(jax_model.params, jnp.asarray(x)))
    assert tuple(got.mean.shape) == (2, 1, 8, 8, CFG["z_dim"])


def test_whole_clip_single_frame_decode_matches_jax(pairs):
    port, jax_model = pairs["CFG"]
    z = np.random.default_rng(1).standard_normal((2, 1, 4, 4, 4)).astype(np.float32)
    got = port.decode(torch.from_numpy(z))
    _close(got, jax_model._dec(jax_model.params, jnp.asarray(z)))
    assert tuple(got.shape) == (2, 1, 16, 16, 3) and float(got.abs().max()) <= 1.0


@pytest.mark.parametrize("name", ["CFG", "CFG2"])
def test_whole_clip_five_frames_match_jax(pairs, name):
    """The temporal branches of the whole-clip path (T > 1): the stride-2
    temporal downsample with one front frame, the channel-doubling
    upsample's interleave."""
    port, jax_model = pairs[name]
    x = _clip(2, 5)
    got = port.encode(torch.from_numpy(x))
    _close(got.parameters, jax_model._enc(jax_model.params, jnp.asarray(x)))
    frames = {"CFG": 2, "CFG2": 1}[name]
    assert tuple(got.mean.shape) == (1, frames, 4, 4, 4)
    rec = port.decode(got.mean)
    _close(rec, jax_model._dec(jax_model.params, jnp.asarray(got.mean.numpy())))
    assert tuple(rec.shape) == (1, {"CFG": 4, "CFG2": 1}[name], 16, 16, 3)


@pytest.mark.parametrize("name", ["CFG", "CFG2"])
@pytest.mark.parametrize("frames", [5, 9])
def test_chunked_encode_matches_jax(pairs, name, frames):
    port, jax_model = pairs[name]
    x = _clip(frames + 7, frames)
    got = port.encode_chunked(torch.from_numpy(x))
    _close(got.parameters, jax_model._enc_chunked(jax_model.params, jnp.asarray(x)))
    stages = sum(dict(CFG=CFG, CFG2=CFG2)[name]["temperal_downsample"])
    assert got.mean.shape[1] == 1 + (frames - 1) // 2 ** stages


@pytest.mark.parametrize("name", ["CFG", "CFG2"])
@pytest.mark.parametrize("latent_frames", [2, 3])
def test_chunked_decode_matches_jax(pairs, name, latent_frames):
    """One latent frame a chunk: the first gives one frame, each later one
    2 ** stages (3 and 5 frames out at one temporal stage, 5 and 9 at
    two)."""
    port, jax_model = pairs[name]
    z = _latent(latent_frames + 20, latent_frames)
    got = port.decode_chunked(torch.from_numpy(z))
    _close(got, jax_model.decode_chunked(jnp.asarray(z)))
    stages = sum(dict(CFG=CFG, CFG2=CFG2)[name]["temperal_downsample"])
    assert got.shape[1] == 1 + 2 ** stages * (latent_frames - 1)
    assert float(got.abs().max()) <= 1.0


def test_first_chunk_is_the_whole_clip_of_frame_zero(pairs):
    """The streaming path's first chunk is frame 0 alone through the
    whole-clip modules, bit for bit."""
    port, _ = pairs["CFG2"]
    x = torch.from_numpy(_clip(30, 9))
    chunked = port.encode_chunked(x)
    whole = port.encode(x[:, :1])
    assert torch.equal(chunked.parameters[:, :1], whole.parameters)
    z = chunked.mean
    assert torch.equal(port.decode_chunked(z)[:, :1], port.decode(z[:, :1]))
    with pytest.raises(ValueError, match="1 \\+ 4k"):
        port.encode_chunked(x[:, :4])


@pytest.mark.parametrize("name", ["AutoencoderKLQwenImage", "AutoencoderKLWAN"])
def test_wrappers_match_jax_with_injected_eps(name):
    wrapper = getattr(ptp, name)(seed=5, device="cpu", **WRAPPED)
    with shape_only_init():
        jax_wrapper = getattr(jtp, name)(**WRAPPED)
    jax_wrapper.model.params = _carry(wrapper.model.state_dict(), jax_wrapper.model.params)
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    z, log = wrapper.encode(torch.from_numpy(x), return_reg_log=True, eps=torch.from_numpy(eps))
    assert log == {} and tuple(z.shape) == (2, 8, 8, 4)
    moments = np.asarray(jax_wrapper.model._enc(jax_wrapper.model.params, jnp.asarray(x)[:, None]))
    mean, logvar = np.split(moments[:, 0], 2, axis=-1)
    _close(z, mean + np.exp(0.5 * np.clip(logvar, -30.0, 20.0)) * eps)
    rec = wrapper.decode(z)
    _close(rec, jax_wrapper.decode(jnp.asarray(z.numpy())))
    assert tuple(rec.shape) == (2, 16, 16, 3)
    drawn, _ = wrapper.encode(torch.from_numpy(x))  # the wrapper's generator
    assert tuple(drawn.shape) == (2, 8, 8, 4) and torch.isfinite(drawn).all()


def test_load_checkpoint_reads_the_diffusers_names(pairs, tmp_path):
    port, _ = pairs["CFG"]
    sd = {k: (v.reshape(-1, 1, 1, 1) if k.endswith(".gamma") else v)
          for k, v in port.state_dict().items()}  # diffusers keeps gamma (C, 1, 1, 1)
    torch.save(sd, tmp_path / "wan.pt")
    fresh = AutoencoderKLWan(**CFG, seed=9, device="cpu")
    assert fresh.load_checkpoint(str(tmp_path / "wan.pt")) == ([], [])
    own = port.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in fresh.state_dict().items())


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoencoderKLWan()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptp.AutoencoderKLQwenImage()
