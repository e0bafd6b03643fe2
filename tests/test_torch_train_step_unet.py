"""The port's two-phase GAN training step on the UNet (sd3unet) engine
against the JAX package's ``TrainStepBuilder``: a small form of
``configs/sd3unet_gq_0.25.yaml`` (ch 32, ch_mult [1, 2], one res block,
attention at 16x16, z 4, 32x32 images, ndf 8, the GQ regularizer in the
config's ``bchw`` format with 256 codes).

Float32: losses, d_weight, the duals and every gradient of both phases
within 1e-4 relative L2 (the ViT test's bars, tests/test_torch_train_step.py,
whose helpers this file shares), with the JAX eps patched to the port's
numpy draw.  The weights go the other way from the ViT test's, to keep the
file fast: the port's seeded engine and its loss head after ``init_state``
(ActNorm's data init on the first batch) are carried into the JAX package
through its own converter onto ``jax.eval_shape`` templates, so no JAX
init is compiled.
bf16: the port's engine at bf16 compute on the CPU walks the fused
structure (the resample and attention autograd Functions through their
plain versions, the statistics handoff and the deferred add); its ae
gradient is held to the JAX float32 gradient within 0.1 relative L2, the
bar the card's run holds the bf16 step to.  That comparison runs with the
discriminator inactive: at this random init the adaptive weight is in the
hundreds and multiplies bf16 rounding in the generator term's path, so
that with the term on even the JAX package's own bf16 ae gradient lies
beyond 0.1 of its float32 one.  The same bf16 engine then runs its ae phase
again with ``GVQ_CONV_WGRAD=1`` and ``GVQ_GN_BWD=1`` (read at forward time):
every resblock conv takes the wgrad Function and every GroupNorm + swish site
without resample statistics the GroupNorm + swish Function, and the gradient
is held to the same JAX float32 one under the same bar.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import _check_logs, _FixedNormal, _flat_grads, _np
from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.parallel.train_state import init_train_state
from vqvae_from_gaussian_vae_tpu.parallel.train_state import make_optimizers as jax_make_optimizers
from vqvae_from_gaussian_vae_tpu.parallel.train_step import TrainStepBuilder as JaxBuilder
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.ops import conv3x3_train, gn_swish_bwd
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import make_optimizers
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder

PKG = "vqvae_from_gaussian_vae_tpu"
GRAD_REL_L2 = 1e-4   # float32 on both sides; summation order only
# Some gradients are zero in exact arithmetic: a conv bias that only feeds a
# GroupNorm of one channel per group (ch 32 in 32 groups, through the
# residual stream too) and attention's k bias (softmax is shift-invariant).
# Both packages give float32 noise there (norms ~1e-5 against ~4 for the
# smallest gradient that is not zero); such a tensor (JAX norm below
# ZERO_REL of the whole gradient's norm) must be as small in the port.
ZERO_REL = 1e-7
BF16_GRAD_REL_L2 = 0.1  # the port at bf16 compute against JAX float32, all tensors together
DUAL_TOL = 1e-6
_UNET = {"ch": 32, "out_ch": 3, "ch_mult": [1, 2], "num_res_blocks": 1,
         "attn_resolutions": [16], "in_channels": 3, "resolution": 32, "z_channels": 4,
         "double_z": True, "dropout": 0.0, "attn_type": "vanilla"}
CONFIG = {
    "target": f"{PKG}.models.autoencoder.AutoencodingEngine",
    "params": {
        "input_key": "img",
        "loss_config": {
            "target": f"{PKG}.losses.discriminator_loss.GeneralLPIPSWithDiscriminator",
            "params": {
                "perceptual_weight": 1.0, "disc_start": 0, "disc_weight": 0.75,
                "learn_logvar": True, "regularization_weights": {"kl_loss": 0.1},
                "additional_log_keys": ["kl_loss", "bits-mean", "bits-min", "bits-max"],
                "discriminator_config": {
                    "target": f"{PKG}.losses.discriminator.NLayerDiscriminator",
                    "params": {"input_nc": 3, "ndf": 8, "n_layers": 2, "use_actnorm": True},
                },
            },
        },
        "regularizer_config": {
            "target": f"{PKG}.quantization.gaussian.GaussianQuantRegularizer",
            "params": {"format": "bchw", "group": 4, "n_samples": 256, "seed": 7,
                       "backend": "xla"},
        },
        "encoder_config": {"target": f"{PKG}.models.unet.Encoder", "params": _UNET},
        "decoder_config": {"target": f"{PKG}.models.unet.Decoder", "params": _UNET},
    },
}
EPS_SHAPE = (2, 16 * 16, 4)  # (B, latent pixels, z)


def _batch(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


def _eps(seed):
    return np.random.default_rng(100 + seed).standard_normal(EPS_SHAPE).astype(np.float32)


def _worst_gradient(pgrads, jgrads):
    """(relative L2 error, name) of the worst tensor; exact-zero gradients
    count as 0 while the port's norm stays under the zero bound, else as
    infinity."""
    assert set(pgrads) == set(jgrads)
    whole = np.linalg.norm(np.concatenate([np.ravel(v) for v in jgrads.values()]))
    worst = (0.0, None)
    for k, want in jgrads.items():
        got = pgrads[k].numpy()
        if np.linalg.norm(want) < ZERO_REL * whole:
            err = 0.0 if np.linalg.norm(got) < ZERO_REL * whole else float("inf")
        else:
            err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        worst = max(worst, (err, k), key=lambda t: t[0])
    return worst


def _port_builder(dtype="float32"):
    cfg = copy.deepcopy(CONFIG)
    for key in ("encoder_config", "decoder_config"):
        cfg["params"][key]["params"]["dtype"] = dtype
    peng = instantiate_from_config(cfg, device="cpu")
    return peng, TrainStepBuilder(peng, *make_optimizers(1e-4))


def _jax_state_from_port(jb, peng, x):
    """The JAX train state holding the port's engine and loss weights."""
    rng = jax.random.PRNGKey(0)

    def template(fn):
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(fn, x))

    eng_t = template(lambda x: jb.module.init({"params": rng, "sample": rng}, x,
                                              train=False)["params"])
    loss_t = template(lambda x: jb.loss_mod.init({"params": rng}, x, x,
                                                 method="init_all")["params"])
    prefixes = {p: p for p in ("encoder.", "decoder.", "regularization.")}
    eng_params, _, _ = convert_state_dict(peng.state_dict(), eng_t, prefix_map=prefixes,
                                          strict=True)
    loss_params, _, _ = convert_state_dict(peng.loss.state_dict(), loss_t, strict=True)
    jb.engine.params = eng_params
    return init_train_state(jax.random.fold_in(rng, 3), eng_params, loss_params,
                            jb.ae_opt, jb.disc_opt)


def _counting(fn, calls, key):
    def wrapped(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapped


@pytest.fixture(scope="module")
def run():
    """Both packages through init, the ae phase, the disc phase and eval."""
    mp = pytest.MonkeyPatch()
    try:
        return _run(mp)
    finally:
        mp.undo()


def _run(mp):
    out = {}
    x0, x1, x2 = _batch(0), _batch(1), _batch(2)
    e0, e1, e2 = _eps(0), _eps(1), _eps(2)

    peng, pb = _port_builder()
    pstate = pb.init_state(0, {"img": x0}, eps=torch.from_numpy(e0))
    out["last_layer"] = pb.last_layer_path
    jb = JaxBuilder(jax_instantiate(copy.deepcopy(CONFIG)), *jax_make_optimizers(1e-4))
    jstate = _jax_state_from_port(jb, peng, jnp.asarray(x0))

    mp.setattr(jax.random, "normal", _FixedNormal(e1))
    logvar = jstate.loss_params["logvar"]
    ae_grad = jax.jit(jax.grad(jb._ae_loss, has_aux=True), static_argnums=(4,))
    (jg_eng, jg_logvar), (jlog, jreg) = ae_grad(
        (jstate.engine_params, logvar), jstate, jnp.asarray(x1), jax.random.PRNGKey(1), True)
    pg, plog, _ = pb.ae_grads(pstate, {"img": x1}, disc_active=True, eps=torch.from_numpy(e1))
    jgrads = {**_flat_grads(jg_eng), "loss.logvar": _np(jg_logvar)}
    out["ae"] = (jlog, plog, jgrads, pg)

    # the ae phase without the generator term on a bf16-compute port engine
    # with the same weights (float32 parameters), against JAX float32
    (jg_eng, jg_logvar), _ = ae_grad(
        (jstate.engine_params, logvar), jstate, jnp.asarray(x1), jax.random.PRNGKey(1), False)
    peng16, pb16 = _port_builder("bfloat16")
    peng16.load_state_dict(peng.state_dict())
    peng16.loss.load_state_dict(peng.loss.state_dict())
    pg16, _, _ = pb16.ae_grads(pstate, {"img": x1}, disc_active=False, eps=torch.from_numpy(e1))
    jgrads16 = {**_flat_grads(jg_eng), "loss.logvar": _np(jg_logvar)}
    out["ae_bf16"] = (jgrads16, pg16, peng16)
    with pytest.MonkeyPatch.context() as m:  # the training kernels' Functions, counted
        m.setenv("GVQ_CONV_WGRAD", "1")
        m.setenv("GVQ_GN_BWD", "1")
        calls = {"conv3x3_wgrad": 0, "gn_swish_bwd": 0}
        for mod, name, key in ((conv3x3_train, "conv3x3_wgrad_plain", "conv3x3_wgrad"),
                               (gn_swish_bwd, "gn_swish_bwd_plain", "gn_swish_bwd")):
            m.setattr(mod, name, _counting(getattr(mod, name), calls, key))
        pgk, _, _ = pb16.ae_grads(pstate, {"img": x1}, disc_active=False,
                                  eps=torch.from_numpy(e1))
    out["ae_bf16_kernels"] = (jgrads16, pgk, calls)

    mp.setattr(jax.random, "normal", _FixedNormal(e2))

    @jax.jit
    def disc_phase(state, x):  # _disc_step's forward and gradient, without the update
        z, reg = jb.module.apply({"params": state.engine_params}, x, return_reg_log=True,
                                 train=True, duals=state.duals, method="encode",
                                 rngs={"sample": jax.random.PRNGKey(2)})
        xrec = jb.module.apply({"params": state.engine_params}, z, train=False, method="decode")
        grads, log = jax.grad(jb._disc_loss, has_aux=True)(
            state.loss_params["discriminator"], state, x, xrec)
        return grads, log, reg

    jg_disc, jlog_d, jreg_d = disc_phase(jstate, jnp.asarray(x2))
    pg_d, plog_d, _ = pb.disc_grads(pstate, {"img": x2}, eps=torch.from_numpy(e2))
    out["disc"] = (jlog_d, plog_d, _flat_grads(jg_disc, "loss.discriminator."), pg_d)

    mp.setattr(jax.random, "normal", _FixedNormal(e0))
    out["eval"] = (jb.eval_step(jstate, {"img": jnp.asarray(x0)}),
                   pb.eval_step(pstate, {"img": x0}, eps=torch.from_numpy(e0)))

    jd_ae = jb._update_duals(jstate.duals, jreg)
    jd_disc = jb._update_duals(jd_ae, jreg_d)
    pstate, _ = pb.ae_step(pstate, {"img": x1}, disc_active=True, eps=torch.from_numpy(e1))
    p_ae = dict(pstate.duals)
    pstate, _ = pb.disc_step(pstate, {"img": x2}, eps=torch.from_numpy(e2))
    out["duals"] = [(jd_ae, p_ae), (jd_disc, pstate.duals)]
    return out


def test_builder_takes_the_decoder_conv_out_as_last_layer(run):
    assert run["last_layer"] == "decoder.conv_out.weight"


def test_ae_phase_losses_and_d_weight_match_jax(run):
    jlog, plog, _, _ = run["ae"]
    assert "train/kl_loss" in plog and float(plog["train/scalars/d_weight"]) > 0.0
    _check_logs(jlog, plog)


def test_ae_phase_gradients_match_jax(run):
    _, _, jgrads, pgrads = run["ae"]
    worst = _worst_gradient(pgrads, jgrads)
    assert worst[0] <= GRAD_REL_L2, worst


def test_bf16_ae_gradient_is_near_the_jax_float32_one(run):
    jgrads, pg16, peng16 = run["ae_bf16"]
    enc, dec = peng16.encoder, peng16.decoder
    assert enc.down[0].downsample.fused and dec.up[1].upsample.fused
    assert all(p.dtype == torch.float32 for p in peng16.module.parameters())
    assert set(pg16) == set(jgrads)
    names = sorted(jgrads)
    got = np.concatenate([pg16[k].float().numpy().ravel() for k in names])
    want = np.concatenate([np.ravel(jgrads[k]) for k in names])
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= BF16_GRAD_REL_L2, rel


def test_bf16_ae_gradient_through_the_training_kernels_is_near_the_jax_float32_one(run):
    jgrads, pgk, calls = run["ae_bf16_kernels"]
    # 10 resblocks: 20 convs; 20 GroupNorm + swish sites less the 2 that
    # normalise from a fused resample's statistics
    assert calls == {"conv3x3_wgrad": 20, "gn_swish_bwd": 18}
    assert set(pgk) == set(jgrads)
    names = sorted(jgrads)
    got = np.concatenate([pgk[k].float().numpy().ravel() for k in names])
    want = np.concatenate([np.ravel(jgrads[k]) for k in names])
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= BF16_GRAD_REL_L2, rel


def test_disc_phase_losses_and_gradients_match_jax(run):
    jlog, plog, jgrads, pgrads = run["disc"]
    _check_logs(jlog, plog)
    worst = _worst_gradient(pgrads, jgrads)
    assert worst[0] <= GRAD_REL_L2, worst


def test_eval_step_matches_jax(run):
    jlog, plog = run["eval"]
    _check_logs(jlog, plog)


@pytest.mark.parametrize("after", ["ae_step", "disc_step"])
def test_duals_match_jax(run, after):
    jduals, pduals = run["duals"][0 if after == "ae_step" else 1]
    for k in ("lam", "lam_min", "lam_max"):
        np.testing.assert_allclose(float(pduals[k]), float(jduals[k]), atol=DUAL_TOL)
