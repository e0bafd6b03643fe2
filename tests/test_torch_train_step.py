"""The port's two-phase GAN training step against the JAX package's
``TrainStepBuilder``, on the small ViT engine of tests/test_vit_training.py
(width 32, 2 layers, 4 heads, 32x32 images, ndf 8), in float32.

The JAX engine's and loss head's seeded weights go across through
``state_dict_from_jax``; the same numpy batch goes through both.  The JAX
regularizer draws eps with ``jax.random.normal``: the test patches it, for
the duration of each JAX call, to return the numpy eps the port is given.
Gradients and losses are compared at the same parameters (not parameters
after Adam's first step, which moves each by about lr * sign(g)).  The JAX
side runs its builder's own pieces (``_ae_loss``, ``_disc_loss``,
``_update_duals``, ``eval_step``, and ``init_state``'s three calls) under
``jax.jit``, which keeps the file inside a few tens of seconds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
from vqvae_from_gaussian_vae_tpu.parallel.train_state import init_train_state
from vqvae_from_gaussian_vae_tpu.parallel.train_state import make_optimizers as jax_make_optimizers
from vqvae_from_gaussian_vae_tpu.parallel.train_step import TrainStepBuilder as JaxBuilder
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import make_optimizers
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

PKG = "vqvae_from_gaussian_vae_tpu"
GRAD_REL_L2 = 1e-4   # float32 on both sides; summation order only
LOSS_RTOL = 1e-4
DUAL_TOL = 1e-6
_VIT = {"double_z": True, "z_channels": 4, "image_size": 32, "patch_size": 8, "width": 32,
        "layers": 2, "heads": 4, "mlp_ratio": 2, "drop_rate": 0.0}
CONFIG = {
    "target": f"{PKG}.models.autoencoder.AutoencodingEngine",
    "params": {
        "input_key": "img",
        "clamp_range": [-1, 1],
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
            "params": {"format": "blc", "group": 4, "n_samples": 256, "seed": 7,
                       "backend": "xla"},
        },
        "encoder_config": {"target": f"{PKG}.models.vit.TransformerEncoder", "params": _VIT},
        "decoder_config": {"target": f"{PKG}.models.vit.TransformerDecoder",
                           "params": {**_VIT, "dim_ffn_output": 64}},
    },
}
EPS_SHAPE = (2, 16, 4)  # (B, L, z): 16 tokens at 32 px / patch 8


def _batch(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


def _eps(seed):
    return np.random.default_rng(100 + seed).standard_normal(EPS_SHAPE).astype(np.float32)


class _FixedNormal:
    """Stands in for jax.random.normal: returns the given numpy eps."""

    def __init__(self, eps):
        self.eps = eps

    def __call__(self, key, shape, dtype=jnp.float32):
        return jnp.asarray(self.eps.reshape(shape), dtype)


def _np(x):
    return np.asarray(x, np.float32)


def _rel_l2(got, want):
    """Relative L2 error; a gradient that is zero in exact arithmetic (the
    last conv's bias under the hinge loss, whose real and fake halves
    cancel) is held to an absolute 1e-7 (norm floor 1e-3; the others are
    O(0.1 - 10) here)."""
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-3))


def _flat_grads(tree, prefix=""):
    """JAX gradient tree -> {port state_dict name: array in the port's layout}."""
    sd = state_dict_from_jax(jax.tree.map(np.asarray, tree))
    return {prefix + k: v.numpy() for k, v in sd.items()}


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

    jeng = jax_instantiate(copy.deepcopy(CONFIG))
    jb = JaxBuilder(jeng, *jax_make_optimizers(1e-4))
    mp.setattr(jax.random, "normal", _FixedNormal(e0))
    jstate = _jax_init_state(jb, jnp.asarray(x0))

    peng = instantiate_from_config(copy.deepcopy(CONFIG), device="cpu")
    peng.load_state_dict(state_dict_from_jax(jstate.engine_params), strict=True)
    peng.loss.load_state_dict(state_dict_from_jax(jstate.loss_params), strict=True)
    with torch.no_grad():  # the data init must recompute loc / scale, not keep JAX's
        for m in peng.loss.discriminator.modules():
            if hasattr(m, "loc"):
                m.loc.zero_()
                m.scale.fill_(1.0)
    pb = TrainStepBuilder(peng, *make_optimizers(1e-4))
    pstate = pb.init_state(0, {"img": x0}, eps=torch.from_numpy(e0))
    # copies: the port's steps below update the parameters in place
    out["loss_sd"] = {k: v.numpy().copy() for k, v in peng.loss.state_dict().items()}
    out["actnorm"] = (jax.tree.map(np.asarray, jstate.loss_params["discriminator"]),
                      out["loss_sd"])
    out["jax_loss_params"] = jax.tree.map(np.asarray, jstate.loss_params)

    # phase 0 gradients at the initial parameters
    mp.setattr(jax.random, "normal", _FixedNormal(e1))
    logvar = jstate.loss_params["logvar"]
    ae_grad = jax.jit(jax.grad(jb._ae_loss, has_aux=True), static_argnums=(4,))
    (jg_eng, jg_logvar), (jlog, jreg) = ae_grad(
        (jstate.engine_params, logvar), jstate, jnp.asarray(x1), jax.random.PRNGKey(1), True)
    pg, plog, _ = pb.ae_grads(pstate, {"img": x1}, disc_active=True, eps=torch.from_numpy(e1))
    out["ae"] = (jlog, plog, {**_flat_grads(jg_eng), "loss.logvar": _np(jg_logvar)}, pg)

    # phase 1 gradients at the initial parameters
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

    # eval at the initial parameters
    mp.setattr(jax.random, "normal", _FixedNormal(e0))
    out["eval"] = (jb.eval_step(jstate, {"img": jnp.asarray(x0)}),
                   pb.eval_step(pstate, {"img": x0}, eps=torch.from_numpy(e0)))

    # the duals after each step: the JAX steps' own update on their
    # forwards' statistics, against the port's steps (whose disc phase runs
    # at the parameters its ae step left, a move of about lr per weight)
    jd_ae = jb._update_duals(jstate.duals, jreg)
    jd_disc = jb._update_duals(jd_ae, jreg_d)
    pstate, _ = pb.ae_step(pstate, {"img": x1}, disc_active=True, eps=torch.from_numpy(e1))
    p_ae = dict(pstate.duals)
    pstate, _ = pb.disc_step(pstate, {"img": x2}, eps=torch.from_numpy(e2))
    out["duals"] = [(jd_ae, p_ae), (jd_disc, pstate.duals)]
    out["steps"] = pstate.step
    return out


def _jax_init_state(jb, x):
    """JAX ``TrainStepBuilder.init_state``'s calls, each under jit: engine
    init, the eval reconstruction, the loss init on the real batch (ActNorm's
    data init), the train state."""
    rng = jax.random.PRNGKey(0)
    p_rng, s_rng = jax.random.split(jax.random.fold_in(rng, 0))
    jb.engine.params = jax.jit(lambda x: jb.module.init(
        {"params": p_rng, "sample": s_rng}, x, train=False)["params"])(x)
    _, xrec, _ = jax.jit(lambda p, x: jb.module.apply(
        {"params": p}, x, train=False, rngs={"sample": jax.random.fold_in(rng, 1)}))(
        jb.engine.params, x)
    loss_vars = jax.jit(lambda x, xr: jb.loss_mod.init(
        {"params": jax.random.fold_in(rng, 2)}, x, xr, method="init_all"))(x, xrec)
    return init_train_state(jax.random.fold_in(rng, 3), jb.engine.params, loss_vars["params"],
                            jb.ae_opt, jb.disc_opt)


def _check_logs(jlog, plog):
    assert set(plog) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(_np(plog[k]), _np(jlog[k]), rtol=LOSS_RTOL, atol=1e-5,
                                   err_msg=k)


def test_actnorm_data_init_matches_jax(run):
    jdisc, sd = run["actnorm"]
    checked = 0
    for key, value in sd.items():
        if key.endswith((".loc", ".scale")):
            _, _, idx, leaf = key.split(".")
            np.testing.assert_allclose(value.transpose(0, 2, 3, 1), jdisc[f"main_{idx}"][leaf],
                                       rtol=1e-4, atol=1e-5, err_msg=key)
            checked += 1
    assert checked == 4


def test_ae_phase_losses_and_log_keys_match_jax(run):
    jlog, plog, _, _ = run["ae"]
    assert "train/kl_loss" in plog and "train/bits-max" in plog
    _check_logs(jlog, plog)


def test_ae_phase_d_weight_matches_jax(run):
    jlog, plog, _, _ = run["ae"]
    d = float(plog["train/scalars/d_weight"])
    assert d > 0.0
    np.testing.assert_allclose(d, float(jlog["train/scalars/d_weight"]), rtol=LOSS_RTOL)


def test_ae_phase_gradients_match_jax(run):
    _, _, jgrads, pgrads = run["ae"]
    assert set(pgrads) == set(jgrads)
    worst = max((_rel_l2(pgrads[k].numpy(), jgrads[k]), k) for k in jgrads)
    assert worst[0] <= GRAD_REL_L2, worst


def test_disc_phase_losses_and_gradients_match_jax(run):
    jlog, plog, jgrads, pgrads = run["disc"]
    _check_logs(jlog, plog)
    assert set(pgrads) == set(jgrads)
    worst = max((_rel_l2(pgrads[k].numpy(), jgrads[k]), k) for k in jgrads)
    assert worst[0] <= GRAD_REL_L2, worst


def test_eval_step_matches_jax(run):
    jlog, plog = run["eval"]
    _check_logs(jlog, plog)


@pytest.mark.parametrize("after", ["ae_step", "disc_step"])
def test_duals_match_jax(run, after):
    jduals, pduals = run["duals"][0 if after == "ae_step" else 1]
    for k in ("lam", "lam_min", "lam_max"):
        assert pduals[k].dtype == torch.float32
        np.testing.assert_allclose(float(pduals[k]), float(jduals[k]), atol=DUAL_TOL)
    assert run["steps"] == 2


def test_loss_state_dict_loads_into_jax_strictly(run):
    """The port's loss state_dict goes back through the JAX package's own
    converter with strict=True and gives the JAX tree's values."""
    template = run["jax_loss_params"]
    params, missing, unexpected = convert_state_dict(run["loss_sd"], template, strict=True)
    assert missing == [] and unexpected == []
    want = dict(jax.tree_util.tree_leaves_with_path(template))
    got = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(got) == set(want)
    for path, leaf in want.items():
        if path[-1].key in ("loc", "scale"):
            continue  # recomputed by the port's data init (test_actnorm_data_init_matches_jax)
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


def test_make_optimizers_maps_optax_adam_and_parameter_groups():
    """optax.adam's b1 / b2 / eps become torch.optim.Adam's; a group's lr
    overrides the base (scaled by lr_g_factor for the ae side); a parameter
    no group matches is in no group (frozen)."""
    named = [(n, torch.nn.Parameter(torch.zeros(2)))
             for n in ("encoder.w", "decoder.w", "loss.logvar")]
    ae, disc = make_optimizers(1e-3, {"target": "optax.adam", "params": {"b1": 0.5, "eps": 1e-6}},
                               lr_g_factor=2.0, trainable_ae_params=[["encoder.*"], ["loss.logvar"]],
                               ae_optimizer_args=[{"lr": 1e-2}, {}])
    groups = ae.build(named).param_groups
    assert [len(g["params"]) for g in groups] == [1, 1]
    assert groups[0]["params"][0] is named[0][1] and groups[1]["params"][0] is named[2][1]
    assert [g["lr"] for g in groups] == [1e-2, 2e-3]
    assert all(g["betas"] == (0.5, 0.999) and g["eps"] == 1e-6 for g in groups)
    (group,) = disc.build(named).param_groups
    assert group["lr"] == 1e-3 and len(group["params"]) == 3


@pytest.mark.parametrize("kwargs", [
    {"optimizer_config": {"target": "optax.sgd"}},
    {"optimizer_config": {"target": "optax.adam", "params": {"eps_root": 1e-8}}},
    {"optimizer_config": {"target": "optax.adam", "params": {"nesterov": True}}},
])
def test_make_optimizers_refuses_what_is_not_ported(kwargs):
    with pytest.raises(NotImplementedError):
        make_optimizers(1e-4, **kwargs)


def test_builder_refuses_collectives_and_cut_graphs():
    """A mesh the process group cannot give (tensor parallelism, more
    data-parallel ranks than it has) is refused; a trainable parameter the
    loss does not reach makes the ae phase raise instead of training it
    with a zero gradient."""
    eng = instantiate_from_config(copy.deepcopy(CONFIG), device="cpu")
    for mesh, error in (({"model": 2}, NotImplementedError), ({"data": 2}, ValueError)):
        with pytest.raises(error):
            TrainStepBuilder(eng, *make_optimizers(1e-4), mesh=mesh)
    eng.module.register_parameter("cut", torch.nn.Parameter(torch.zeros(1)))
    pb = TrainStepBuilder(eng, *make_optimizers(1e-4))
    state = pb.init_state(0, {"img": _batch(0)}, eps=torch.from_numpy(_eps(0)))
    with pytest.raises(RuntimeError, match="not have been used"):
        pb.ae_grads(state, {"img": _batch(1)}, disc_active=True, eps=torch.from_numpy(_eps(1)))
