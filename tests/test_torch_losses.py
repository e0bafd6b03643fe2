"""The port's loss head against the JAX package's, in float32 at 1e-4
relative: LPIPS, ActNorm's data init, the NLayerDiscriminator, the hinge
and vanilla losses, and both optimizer_idx branches of
GeneralLPIPSWithDiscriminator.  The JAX modules' seeded parameters go
across through ``state_dict_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_from_gaussian_vae_tpu.losses import discriminator as jdisc
from vqvae_from_gaussian_vae_tpu.losses.discriminator_loss import (
    GeneralLPIPSWithDiscriminator as JaxLoss)
from vqvae_from_gaussian_vae_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqvae_from_gaussian_vae_tpu_torch.losses import discriminator as disc
from vqvae_from_gaussian_vae_tpu_torch.losses.discriminator_loss import (
    GeneralLPIPSWithDiscriminator)
from vqvae_from_gaussian_vae_tpu_torch.losses.lpips import LPIPS
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

RTOL, ATOL = 1e-4, 1e-5
RNG = {"params": jax.random.PRNGKey(0)}
PKG = "vqvae_from_gaussian_vae_tpu"
DISC = {"target": f"{PKG}.losses.discriminator.NLayerDiscriminator",
        "params": {"input_nc": 3, "ndf": 8, "n_layers": 2, "use_actnorm": True}}


def _img(seed, shape=(2, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_lpips_matches_jax():
    x, y = _img(0), _img(1)
    jmod = JaxLPIPS()
    params = jax.jit(lambda a, b: jmod.init(RNG, a, b))(x, y)["params"]
    want = jax.jit(lambda p, a, b: jmod.apply({"params": p}, a, b))(params, x, y)
    mod = LPIPS()
    mod.load_state_dict(state_dict_from_jax(params), strict=True)
    got = mod(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 1, 1, 1) == want.shape
    _close(got.detach(), want)
    assert float(mod(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) == 0.0
    assert not any(p.requires_grad for p in mod.parameters())


def test_actnorm_data_init_matches_jax():
    x = np.random.default_rng(2).standard_normal((4, 6, 6, 8)).astype(np.float32) * 3 + 1
    jmod = jdisc.ActNorm(8)
    params = jmod.init(RNG, jnp.asarray(x))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x))
    mod = disc.ActNorm(8)
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2), init=True).permute(0, 2, 3, 1)
    _close(mod.loc.detach().permute(0, 2, 3, 1), params["loc"])
    _close(mod.scale.detach().permute(0, 2, 3, 1), params["scale"])
    _close(got, want)


@pytest.mark.parametrize("use_actnorm", [True, False])
def test_nlayer_discriminator_matches_jax(use_actnorm):
    x = _img(3, (2, 64, 64, 3))
    jmod = jdisc.NLayerDiscriminator(input_nc=3, ndf=8, n_layers=3, use_actnorm=use_actnorm)
    variables = jax.jit(lambda a: jmod.init(RNG, a, train=use_actnorm))(x)
    want = jax.jit(lambda v, a: jmod.apply(v, a))(
        {"params": variables["params"], **({} if use_actnorm else {
            "batch_stats": variables["batch_stats"]})}, x)
    mod = disc.NLayerDiscriminator(input_nc=3, ndf=8, n_layers=3, use_actnorm=use_actnorm)
    sd = state_dict_from_jax(variables["params"])
    if use_actnorm:
        mod.load_state_dict(sd, strict=True)
        with torch.no_grad():  # the data init recomputes loc / scale
            got = mod(torch.from_numpy(x), train=True, init=True)
        for key, value in sd.items():
            if key.endswith((".loc", ".scale")):
                _close(mod.state_dict()[key], value)
    else:
        mod.load_state_dict(sd, strict=False)  # BatchNorm's running stats stay (0, 1)
        with torch.no_grad():
            got = mod(torch.from_numpy(x))
        with pytest.raises(NotImplementedError):
            mod(torch.from_numpy(x), train=True)
    assert got.shape == want.shape
    _close(got, want)


def test_d_losses_match_jax():
    lr, lf = (np.random.default_rng(s).standard_normal((4, 3, 3, 1)).astype(np.float32)
              for s in (4, 5))
    for jfn, fn in ((jdisc.hinge_d_loss, disc.hinge_d_loss),
                    (jdisc.vanilla_d_loss, disc.vanilla_d_loss)):
        _close(fn(torch.from_numpy(lr), torch.from_numpy(lf)),
               jfn(jnp.asarray(lr), jnp.asarray(lf)))


@pytest.fixture(scope="module")
def heads():
    kw = dict(disc_start=5, disc_weight=0.75, learn_logvar=True, logvar_init=0.3,
              regularization_weights={"kl_loss": 0.1},
              additional_log_keys=["kl_loss", "bits-mean"], discriminator_config=DISC)
    x, xrec = _img(6), _img(7)
    jmod = JaxLoss(**kw)
    params = jax.jit(lambda a, b: jmod.init(RNG, a, b, method="init_all"))(x, xrec)["params"]
    mod = GeneralLPIPSWithDiscriminator(**kw)
    mod.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmod, params, mod, x, xrec


@pytest.mark.parametrize("optimizer_idx", [0, 1])
@pytest.mark.parametrize("step,train", [(10, True), (0, True), (0, False)])
def test_loss_head_matches_jax(heads, optimizer_idx, step, train):
    jmod, params, mod, x, xrec = heads
    reg = {"kl_loss": 2.5, "bits-mean": 7.9, "lam": 1.0}
    kw = dict(optimizer_idx=optimizer_idx, global_step=step, split="train" if train else "val",
              train=train)
    d_weight = 0.6 if (optimizer_idx == 0 and train) else None

    @jax.jit
    def jax_head(p, a, b):
        return jmod.apply({"params": p}, a, b, regularization_log={
            k: jnp.float32(v) for k, v in reg.items()}, d_weight=d_weight, **kw)

    jloss, jlog = jax_head(params, x, xrec)
    loss, log = mod(torch.from_numpy(x), torch.from_numpy(xrec), d_weight=d_weight,
                    regularization_log={k: torch.tensor(v) for k, v in reg.items()}, **kw)
    _close(loss.detach(), jloss)
    assert set(log) == set(jlog)
    for k in jlog:
        _close(log[k], jlog[k])
