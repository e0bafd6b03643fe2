"""The port's fused GroupNorm + swish + conv against the JAX package's
(``ops/fused_gn_conv.py``, the Pallas kernel in interpret mode), and the
UNet's ``fused_gn_conv`` knob and kernel gates against the JAX model's.

float32 within the JAX test's 1e-5 (``tests/test_fused_gn_conv.py``); bf16
within one bf16 ulp of the JAX kernel's bf16 result; a ResnetBlock and a
small Decoder built with ``fused_gn_conv=True`` within 2e-5 of the JAX ones:
the port's seeded weights go into the JAX model through its strict converter
(onto ``jax.eval_shape`` templates, so no JAX init is compiled) and back
through the port's ``utils/convert.py``, unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models import unet as junet
from vqvae_from_gaussian_vae_tpu.ops import fused_gn_conv as jfused
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch.models import unet
from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import init_weights
from vqvae_from_gaussian_vae_tpu_torch.ops import fused_gn_conv as fused
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

TOL = 1e-5        # float32: the JAX kernel test's bar
MODULE_TOL = 2e-5  # ResnetBlock and Decoder: the JAX fused-decoder test's bar
CFG = dict(attn_type="vanilla", double_z=True, z_channels=4, resolution=32, in_channels=3,
           out_ch=3, ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)


def _op_inputs(b, h, w, c, o, seed, residual=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, w, c)), rng.standard_normal(c), rng.standard_normal(c),
            rng.standard_normal((3, 3, c, o)) * 0.05, rng.standard_normal(o) * 0.1]
    if residual:
        arrs.append(rng.standard_normal((b, h, w, o)))
    return [a.astype(np.float32) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_gn_affine_matches_jax():
    x, gamma, beta, _, _ = _op_inputs(2, 6, 6, 64, 8, seed=1)
    s, sh = fused.gn_affine(*_t([x, gamma, beta]))
    js, jsh = jfused.gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32)
    assert s.dtype == torch.float32 and s.shape == (2, 64)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,h,w,c,o,bh", [
    (2, 8, 16, 64, 32, 4),
    (1, 12, 8, 32, 64, 4),   # several row bands, C != O
    (2, 8, 16, 64, 32, 8),   # one band: both halos are image borders
])
def test_plain_matches_jax_kernel(b, h, w, c, o, bh):
    arrs = _op_inputs(b, h, w, c, o, seed=0)
    want = jfused.fused_gn_swish_conv(*map(jnp.asarray, arrs), block_h=bh, interpret=True)
    got = fused.fused_gn_swish_conv_plain(*_t(arrs))
    assert got.shape == (b, h, w, o) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # the public op takes the plain version for CPU tensors
    assert torch.equal(fused.fused_gn_swish_conv(*_t(arrs)), got)


def test_plain_residual_branch_matches_jax_kernel():
    x, gamma, beta, w, bias, res = _op_inputs(2, 8, 16, 32, 32, seed=3, residual=True)
    want = jfused.fused_gn_swish_conv(*map(jnp.asarray, (x, gamma, beta, w, bias)), block_h=8,
                                      interpret=True, residual=jnp.asarray(res))
    got = fused.fused_gn_swish_conv(*_t([x, gamma, beta, w, bias]), torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_plain_bf16_is_within_one_ulp_of_the_jax_kernel():
    x, gamma, beta, w, bias, res = _op_inputs(2, 8, 16, 64, 32, seed=4, residual=True)
    want = jfused.fused_gn_swish_conv(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (gamma, beta, w, bias)), block_h=4,
        interpret=True, residual=jnp.asarray(res, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    got = fused.fused_gn_swish_conv(torch.from_numpy(x).to(torch.bfloat16),
                                    *_t([gamma, beta, w, bias]),
                                    torch.from_numpy(res).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    x, gamma, beta, w, bias = _t(_op_inputs(1, 8, 8, 32, 32, seed=5))
    before = fused.fused_gn_swish_conv_cuda.launches
    with pytest.raises(ValueError):
        fused.fused_gn_swish_conv_cuda(x.to(torch.bfloat16), gamma, beta, w, bias)
    assert fused.fused_gn_swish_conv_cuda.launches == before


def _carry(port_module, jax_module, example):
    """The port module's seeded weights (biases and GroupNorm affines moved
    off their init values) as the JAX module's variables, strictly (every
    leaf on both sides), and back through utils/convert.py."""
    init_weights(port_module, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in port_module.parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    sd = {k: v.detach() for k, v in port_module.state_dict().items()}
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda e: jax_module.init(jax.random.PRNGKey(0), e)["params"], example))
    params, _, _ = convert_state_dict(sd, template, strict=True)
    back = state_dict_from_jax(params)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    return {"params": params}


@pytest.fixture(scope="module")
def fused_block():
    """The JAX ResnetBlock built with fused_gn_conv=True, the port's, and the
    port's weights as the JAX block's variables."""
    x = np.random.default_rng(0).standard_normal((2, 16, 8, 64)).astype(np.float32)
    jblock = junet.ResnetBlock(in_channels=64, out_channels=32, fused_gn_conv=True)
    pblock = unet.ResnetBlock(64, 32, fused_gn_conv=True).eval()
    return x, jblock, _carry(pblock, jblock, jnp.asarray(x)), pblock


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_fused_resnet_block_matches_jax(fused_block):
    x, jblock, v, pblock = fused_block
    with torch.no_grad():
        got = pblock(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jblock.apply(v, jnp.asarray(x))), atol=MODULE_TOL)


def test_fused_decoder_matches_jax():
    z = np.random.default_rng(1).standard_normal((1, 16, 16, 4)).astype(np.float32)
    jdec = junet.Decoder(**CFG, fused_gn_conv=True)
    pdec = unet.Decoder(**CFG, fused_gn_conv=True).eval()
    v = _carry(pdec, jdec, jnp.asarray(z))
    with torch.no_grad():
        got = pdec(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdec.apply(v, jnp.asarray(z))), atol=MODULE_TOL)


def test_training_does_not_take_the_fused_op(fused_block, monkeypatch):
    x, _, _, pblock = fused_block
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return fused.fused_gn_swish_conv(*args, **kwargs)

    monkeypatch.setattr(unet, "fused_gn_swish_conv", counting)
    with torch.no_grad():
        trained = pblock(_nchw(x), train=True)
    assert calls == []
    with torch.no_grad():
        inferred = pblock(_nchw(x))
    assert len(calls) == 2  # conv1 and conv2
    # both paths compute the same function (float32, no dropout)
    np.testing.assert_allclose(trained.numpy(), inferred.numpy(), atol=MODULE_TOL)


@pytest.mark.parametrize("disable", [None, "1", "0"])
@pytest.mark.parametrize("fused_train", [None, "0", "1"])
def test_resample_gate_reads_the_environment_as_jax(monkeypatch, disable, fused_train):
    """``_resample_fuses`` against the JAX model's (its TPU clause taken as
    met), over the environment variables, the train flag, heights and
    dtypes."""
    for name, value in (("GVQ_DISABLE_FUSED_KERNELS", disable), ("GVQ_FUSED_TRAIN", fused_train)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for flag in (True, False):
        for train in (True, False):
            for h in (32, 6):
                for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
                    want = junet._resample_fuses(flag, train, h, jdt, train_ok=True)
                    assert unet._resample_fuses(flag, train, h, tdt) == want, (flag, train, h)


def test_training_kernel_gates_read_the_environment(monkeypatch):
    """GVQ_CONV_WGRAD / GVQ_GN_BWD route a bf16 training resblock through the
    training ops; GVQ_DISABLE_FUSED_KERNELS=1 or train=False keeps it off
    them."""
    block = unet.ResnetBlock(32, 32, dtype="bfloat16")
    x = torch.randn((1, 32, 8, 8)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    calls = {"gn_swish": 0, "conv3x3_same_wg": 0}

    def counting(name):
        real = getattr(unet, name)

        def fn(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return fn

    for name in calls:
        monkeypatch.setattr(unet, name, counting(name))
    monkeypatch.setenv("GVQ_CONV_WGRAD", "1")
    monkeypatch.setenv("GVQ_GN_BWD", "1")
    block(x, train=True)
    assert calls == {"gn_swish": 2, "conv3x3_same_wg": 2}
    block(x, train=False)
    monkeypatch.setenv("GVQ_DISABLE_FUSED_KERNELS", "1")
    block(x, train=True)
    assert calls == {"gn_swish": 2, "conv3x3_same_wg": 2}


def test_dropout_drops_only_in_training():
    block = unet.ResnetBlock(32, 32, dropout=0.5)
    x = torch.randn((1, 32, 8, 8))
    with torch.no_grad():
        assert torch.equal(block(x), block(x))
        torch.manual_seed(0)
        a = block(x, train=True)
        torch.manual_seed(1)
        assert not torch.equal(a, block(x, train=True))

