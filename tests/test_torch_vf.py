"""The port's vf alignment branch against the JAX package's, on the JAX
``tests/test_vf_branch.py`` engine (a small sd3unet at 56x56, GQ with 256
codes, the dinov2 trunk shrunk to patch 14, width 64, 2 layers, 4 heads,
LayerScale 1e-5), in both ``reverse_proj`` branches.

The port's seeded engine and loss head (after ``init_state``: ActNorm's
data init) are carried into the JAX package through its own converter onto
``jax.eval_shape`` templates, and the JAX eps is patched to the port's
numpy draw.  Held: the frozen trunk's features within 1e-4, the resize
within 1e-5, ``vf_loss`` within 1e-5, the adaptive vf weight within 1e-3
relative, and one ae step's gradient (both adaptive weights on) within
1e-4 relative L2 over all tensors, each tensor within 1e-3.  The port takes
both of the vf weight's gradients on the step's own graph where the JAX
step reruns the forward with the same eps.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import _FixedNormal, _flat_grads, _np
from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
import tests.test_vf_branch as jax_vf_test
from tests.test_vf_branch import _vf_engine
from vqvae_from_gaussian_vae_tpu.models import foundation as jfnd
from vqvae_from_gaussian_vae_tpu.parallel.train_state import init_train_state
from vqvae_from_gaussian_vae_tpu.parallel.train_state import make_optimizers as jax_make_optimizers
from vqvae_from_gaussian_vae_tpu.parallel.train_step import TrainStepBuilder as JaxBuilder
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.models import foundation as pfnd
from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import resize_bilinear
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import make_optimizers
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder

SMALL_TRUNK = (14, 64, 2, 4, 1e-5)
FEATURE_TOL = 1e-4
RESIZE_TOL = 1e-5
VF_LOSS_TOL = 1e-5
VF_WEIGHT_REL = 1e-3
GRAD_REL_L2 = 1e-4      # all tensors together, float32 on both sides
TENSOR_REL_L2 = 1e-3    # each tensor alone
ZERO_REL = 1e-7         # a gradient zero in exact arithmetic (see test_torch_train_step_unet.py)
EPS_SHAPE = (2, 28 * 28, 4)  # (B, latent pixels, z)


def _batch(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (2, 56, 56, 3)).astype(np.float32)


def _eps(seed):
    return np.random.default_rng(100 + seed).standard_normal(EPS_SHAPE).astype(np.float32)


def _jax_state_from_port(jb, peng, x):
    rng = jax.random.PRNGKey(0)

    def template(fn):
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(fn, x))

    eng_t = template(lambda x: jb.module.init({"params": rng, "sample": rng}, x,
                                              train=False)["params"])
    loss_t = template(lambda x: jb.loss_mod.init({"params": rng}, x, x,
                                                 method="init_all")["params"])
    eng_params, _, _ = convert_state_dict(peng.state_dict(), eng_t, strict=True)
    loss_params, _, _ = convert_state_dict(peng.loss.state_dict(), loss_t, strict=True)
    jb.engine.params = eng_params
    return init_train_state(jax.random.fold_in(rng, 3), eng_params, loss_params,
                            jb.ae_opt, jb.disc_opt)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=[True, False], ids=["reverse_proj", "forward_proj"])
def run(request):
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(jfnd._SPECS, "dinov2", SMALL_TRUNK)
        mp.setitem(pfnd._SPECS, "dinov2", SMALL_TRUNK)
        return _run(mp, request.param)
    finally:
        mp.undo()


def _run(mp, reverse_proj):
    out = {"reverse_proj": reverse_proj}
    x0, x1 = _batch(0), _batch(1)
    e0, e1 = _eps(0), _eps(1)
    jeng = _vf_engine(reverse_proj=reverse_proj)  # sets the JAX trunk to SMALL_TRUNK
    peng = instantiate_from_config(_jax_test_config(reverse_proj), device="cpu")
    pb = TrainStepBuilder(peng, *make_optimizers(1e-4))
    pstate = pb.init_state(0, {"img": x0}, eps=torch.from_numpy(e0))
    jb = JaxBuilder(jeng, *jax_make_optimizers(1e-4))
    jstate = _jax_state_from_port(jb, peng, jnp.asarray(x0))
    out["keys"] = (set(peng.state_dict()), set(_flat_grads(jstate.engine_params)))

    # the JAX side in one compiled call: the frozen trunk's features, the
    # adaptive vf weight on one forward, and one ae step's gradient with both
    # adaptive weights on, all with the same eps
    mp.setattr(jax.random, "normal", _FixedNormal(e1))

    def jax_side(state, x, rng):
        feats = jb.module.apply({"params": state.engine_params}, x,
                                method=lambda m, x: m.foundation(x))
        w = jb._adaptive_vf_weight(state.engine_params, state.loss_params, x, rng, state.duals)
        grads = jax.grad(jb._ae_loss, has_aux=True)(
            (state.engine_params, state.loss_params["logvar"]), state, x, rng, True)
        return feats, w, grads

    feats_j, jw, ((jg_eng, jg_logvar), (jlog, _)) = jax.jit(jax_side)(
        jstate, jnp.asarray(x1), jax.random.PRNGKey(1))
    with torch.no_grad():
        feats_p = peng.module.foundation(torch.from_numpy(x1))
    out["features"] = (np.asarray(feats_j), feats_p.numpy())

    # the adaptive vf weight and vf_loss on one forward
    with torch.enable_grad():
        _, reg_log, _, xrec = pb._forward_split(torch.from_numpy(x1), pstate,
                                                torch.from_numpy(e1))
        nll, _ = peng.loss.nll_from_images(torch.from_numpy(x1), xrec)
        vf = peng.loss.vf_loss(reg_log)
        pw = pb._adaptive_vf_weight(nll, vf)
    jreg = {k: jnp.asarray(reg_log[k].detach().numpy()) for k in ("zp", "aux_feature")}
    jvf = jb.loss_mod.apply({"params": jstate.loss_params}, jreg, method="vf_loss")
    out["vf_weight"] = (float(jw), float(pw))
    out["vf_loss"] = (float(jvf), float(peng.loss.vf_loss(
        {k: v.detach() for k, v in reg_log.items()})))

    # one ae step's gradient, both adaptive weights on, the same eps
    pg, plog, _ = pb.ae_grads(pstate, {"img": x1}, disc_active=True, eps=torch.from_numpy(e1))
    jgrads = {**_flat_grads(jg_eng), "loss.logvar": _np(jg_logvar)}
    out["ae"] = (jlog, plog, jgrads, pg)
    return out


def _jax_test_config(reverse_proj):
    """The config the JAX test's ``_vf_engine`` instantiates (its targets
    name the JAX package; the port's registry maps them), caught at its
    ``instantiate_from_config`` so that both engines share one definition."""
    captured = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_vf_test, "instantiate_from_config", lambda cfg: captured.append(cfg))
        m.setitem(jfnd._SPECS, "dinov2", jfnd._SPECS["dinov2"])
        jax_vf_test._vf_engine(reverse_proj=reverse_proj)
    return copy.deepcopy(captured[0])


def test_state_dict_keys_match_jax(run):
    port_keys, jax_keys = run["keys"]
    assert port_keys == jax_keys
    proj = "linear_proj.bias"
    assert (proj in port_keys) == (not run["reverse_proj"])
    assert "foundation.blocks.1.ls_2.gamma" in port_keys and "foundation.pos_embed" in port_keys


def test_foundation_features_match_jax(run):
    want, got = run["features"]
    assert got.shape == want.shape == (2, 4, 4, 64)
    np.testing.assert_allclose(got, want, rtol=FEATURE_TOL, atol=FEATURE_TOL)


@pytest.mark.parametrize("src,dst", [((2, 14, 14, 4), (4, 4)), ((2, 32, 32, 16), (18, 18)),
                                     ((1, 5, 7, 3), (9, 12))])
def test_resize_matches_jax_image_resize(src, dst):
    z = np.random.default_rng(sum(src)).standard_normal(src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(z), (src[0],) + dst + (src[3],), "bilinear"))
    got = resize_bilinear(torch.from_numpy(z), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


def test_vf_loss_matches_jax(run):
    want, got = run["vf_loss"]
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=VF_LOSS_TOL, atol=VF_LOSS_TOL)


def test_adaptive_vf_weight_matches_jax(run):
    want, got = run["vf_weight"]
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=VF_WEIGHT_REL)


def test_ae_step_gradient_matches_jax(run):
    jlog, plog, jgrads, pgrads = run["ae"]
    assert set(plog) == set(jlog) and "train/loss/vf" in plog
    for k in jlog:
        np.testing.assert_allclose(_np(plog[k]), _np(jlog[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    # the frozen trunk takes no gradient in the port (no parameter of its
    # own); JAX's gradient there is exactly zero
    frozen = [k for k in jgrads if k.startswith("foundation.")]
    assert frozen and all(not np.any(jgrads[k]) for k in frozen)
    assert not any(k.startswith("foundation.") for k in pgrads)
    jgrads = {k: v for k, v in jgrads.items() if not k.startswith("foundation.")}
    assert set(pgrads) == set(jgrads)
    whole = np.linalg.norm(np.concatenate([np.ravel(v) for v in jgrads.values()]))
    got = np.concatenate([pgrads[k].numpy().ravel() for k in jgrads])
    want = np.concatenate([np.ravel(v) for v in jgrads.values()])
    assert _rel_l2(got, want) <= GRAD_REL_L2
    for k, v in jgrads.items():
        if np.linalg.norm(v) < ZERO_REL * whole:
            assert np.linalg.norm(pgrads[k].numpy()) < ZERO_REL * whole, k
        else:
            assert _rel_l2(pgrads[k].numpy(), v) <= TENSOR_REL_L2, k
    assert np.linalg.norm(pgrads["linear_proj.weight"].numpy()) > 0
