"""Data-parallel training of the port over ``torch.distributed`` on the CPU.

Two gloo ranks, spawned as processes with torchrun's environment, train the
tiny UNet + GQ engine of ``tests/test_eval_multihost.py:_tiny_cfg`` (ch 32,
z 4, 256 codes, float32) with the GAN loss head (LPIPS, an 8-wide ActNorm
PatchGAN, the adaptive weight from step 0) at 2 images a rank:
``init_state`` on the joined first batch, one ae step, one disc step.  One
process runs the same at 4 images on the joined batches, with the same
seeds and no injected eps, so the ranks' eps are their rows of the joined
draw.  Held:

- each step's all-reduced gradients, and the parameters after it, against
  the one process's within 1e-5 relative L2 per tensor (float32, summation
  order only); a tensor whose gradient is zero in exact arithmetic (the
  conv biases that feed a GroupNorm of one channel a group, the mid
  attention's k bias) is reported apart, as the other port tests do: its
  gradient as small on both sides and its update at most the learning
  rate; the duals after each step equal, and both ranks' parameters,
  Adam states and duals ``torch.equal``;
- the same steps against the JAX package's ``TrainStepBuilder`` on a
  2-device CPU mesh (``{"data": 2}``: the batch sharded, GSPMD's sums),
  on the port's weights and the port's eps (torch cannot replay
  ``jax.random``): every gradient within 1e-4 relative L2, the duals
  within 1e-6;
- ``grad_allreduce_dtype=bfloat16`` on the disc phase: the ranks' gradients
  are bf16 sums (twice each is a bf16 value) and lie within one bf16 ulp
  (2^-7 relative L2 per tensor) of JAX's ``_cast_reduce_grads`` on the
  mesh: each side rounds twice (each rank's cast, then the sum: the port
  sums bf16(g_r), JAX bf16(g_r / 2)), so the two may round to neighbours;
- ``Trainer.validate`` on the initial state, on shards of 3 and 2 images
  (batches 2 + 1 and 2), finishes and gives the one process's
  image-weighted mean over the 5.
"""

import copy
import os
import socket
import subprocess
import sys
import traceback
import types

import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed
from vqvae_from_gaussian_vae_tpu_torch.parallel import train_step as port_train_step
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import make_optimizers
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder
from vqvae_from_gaussian_vae_tpu_torch.quantization import gaussian as gq

PKG = "vqvae_from_gaussian_vae_tpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PER_RANK = 2
LR = 1e-4
GRAD_REL_L2 = 1e-5     # 2 ranks against one process, float32
JAX_REL_L2 = 1e-4      # against the JAX mesh step, float32
BF16_REL_L2 = 2.0 ** -7  # one bf16 ulp, relative
ZERO_REL = 1e-7        # a gradient under this share of the whole is zero in exact arithmetic
DUAL_TOL = 1e-6
VAL_IMAGES = 5
_UNET = {"attn_type": "vanilla", "double_z": True, "z_channels": 4, "resolution": 32,
         "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
         "attn_resolutions": [], "dropout": 0.0}
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


def _joined(seed, n=WORLD * PER_RANK):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def _cpu(tree):
    """Detached CPU copies of nested dicts, lists and tensors."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _params(engine):
    return {**{k: v for k, v in _cpu(engine.module.state_dict()).items()},
            **{"loss." + k: v for k, v in _cpu(engine.loss.state_dict()).items()}}


def _train(rank: int, world: int):
    """init on the joined first batch, an ae step, a knob disc gradient, a
    disc step: what each produced, on this rank's rows."""
    mine = slice(rank * PER_RANK, (rank + 1) * PER_RANK) if world > 1 else slice(None)
    engine = instantiate_from_config(copy.deepcopy(CONFIG), device="cpu", seed=5)
    builder = TrainStepBuilder(engine, *make_optimizers(LR))
    knob = TrainStepBuilder(engine, *make_optimizers(LR), grad_allreduce_dtype="bfloat16")
    eps, applied = [], []
    draw, apply = gq.draw_eps, port_train_step._apply

    def recording_draw(*args, **kwargs):
        out = draw(*args, **kwargs)
        eps.append(out.clone())
        return out

    def recording_apply(opt, named, grads):
        applied.append(_cpu(grads))
        apply(opt, named, grads)

    gq.draw_eps, port_train_step._apply = recording_draw, recording_apply
    try:
        state = builder.init_state(0, {"img": _joined(0)})
        out = {"init": _params(engine), "init_duals": _cpu(state.duals)}
        gq.draw_eps = draw  # the eval steps' eps are not the training steps'
        out["val"] = _validate(engine, builder, state, rank, world)
        gq.draw_eps = recording_draw
        state, out["ae_log"] = builder.ae_step(state, {"img": _joined(1)[mine]},
                                               disc_active=True)
        out["ae"] = {"grads": applied[-1], "params": _params(engine),
                     "duals": _cpu(state.duals)}
        saved = state.generator.get_state()
        out["knob_grads"] = _cpu(knob.disc_grads(state, {"img": _joined(2)[mine]})[0])
        state.generator.set_state(saved)
        state, out["disc_log"] = builder.disc_step(state, {"img": _joined(2)[mine]})
        out["disc"] = {"grads": applied[-1], "params": _params(engine),
                       "duals": _cpu(state.duals)}
    finally:
        gq.draw_eps, port_train_step._apply = draw, apply
    out["eps"] = [e.numpy() for e in eps]
    out["opt"] = {"ae": _cpu(state.ae_opt.state_dict()["state"]),
                  "disc": _cpu(state.disc_opt.state_dict()["state"])}
    return out


def _validate(engine, builder, state, rank, world):
    """Trainer.validate over this rank's shard of VAL_IMAGES images in
    batches of 2 (the last one short)."""
    import tempfile

    from vqvae_from_gaussian_vae_tpu_torch.parallel.trainer import Trainer

    images = _joined(3, VAL_IMAGES)[rank::world]
    loader = [{"img": images[i:i + 2]} for i in range(0, len(images), 2)]
    with tempfile.TemporaryDirectory() as logdir:
        trainer = Trainer(engine, types.SimpleNamespace(batch_size=2, dataset_configs={}),
                          logdir=logdir, checkpoint_cfg={"monitor": None})
        trainer.builder, trainer.state = builder, state
        return trainer.validate(loader)


def _rank_main(rank, port, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        distributed.maybe_initialize_distributed("cpu")
        out = _train(rank, WORLD)
        out["backend"] = distributed.backend()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        distributed.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks (processes in the background), one process, and the
    JAX mesh steps on the one process's weights and eps."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    port = _free_port()
    code = ("import sys; sys.path.insert(0, {repo!r}); "
            "from tests.test_torch_distributed import _rank_main; "
            "_rank_main({rank}, {port}, {out!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(repo=REPO, rank=r, port=port,
                                                                 out=out_dir)], cwd=REPO)
             for r in range(WORLD)]
    try:
        single = _train(0, 1)
        jax_out = _jax_steps(single)
    finally:
        for p in procs:
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    errors = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
              if f.endswith(".err")]
    assert not errors and all(p.returncode == 0 for p in procs), errors
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"single": single, "ranks": ranks, "jax": jax_out}


def _jax_steps(single):
    """JAX's ae and disc gradients (and the disc one through
    ``_cast_reduce_grads``) on a 2-device mesh, and its dual updates."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_train_step import _FixedNormal, _flat_grads, _np
    from tests.test_torch_train_step_unet import _jax_state_from_port
    from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
    from vqvae_from_gaussian_vae_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from vqvae_from_gaussian_vae_tpu.parallel.train_state import (
        make_optimizers as jax_make_optimizers)
    from vqvae_from_gaussian_vae_tpu.parallel.train_step import TrainStepBuilder as JaxBuilder
    from vqvae_from_gaussian_vae_tpu.parallel.train_step import _cast_reduce_grads

    mesh = make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    jb = JaxBuilder(jax_instantiate(copy.deepcopy(CONFIG)), *jax_make_optimizers(LR))
    x0 = jnp.asarray(_joined(0))

    def state_from(params, duals):
        """A JAX train state of the port's parameters and duals, replicated."""
        eng = {k: v for k, v in params.items() if not k.startswith("loss.")}
        loss = {k[len("loss."):]: v for k, v in params.items() if k.startswith("loss.")}
        port = types.SimpleNamespace(state_dict=lambda: eng, loss=types.SimpleNamespace(
            state_dict=lambda: loss))
        state = _jax_state_from_port(jb, port, x0)
        state = state.replace(duals={k: jnp.asarray(v.numpy()) for k, v in duals.items()})
        return replicate(mesh, state)

    out = {}
    _, e_ae, _, e_disc = single["eps"]  # init, ae, the knob's disc gradient, disc
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.random, "normal", _FixedNormal(e_ae))
        state = state_from(single["init"], single["init_duals"])
        logvar = state.loss_params["logvar"]
        ae_grad = jax.jit(jax.grad(jb._ae_loss, has_aux=True), static_argnums=(4,))
        with mesh:
            x1 = shard_batch(mesh, {"img": _joined(1)})["img"]
            (g_eng, g_logvar), (_, reg) = ae_grad((state.engine_params, logvar), state, x1,
                                                  jax.random.PRNGKey(1), True)
        out["ae"] = {**_flat_grads(g_eng), "loss.logvar": _np(g_logvar)}
        out["ae_duals"] = jax.tree.map(np.asarray, jb._update_duals(state.duals, reg))

        mp.setattr(jax.random, "normal", _FixedNormal(e_disc))
        state = state_from(single["ae"]["params"], single["ae"]["duals"])

        def disc_grads(state, x, knob):
            z, reg = jb.module.apply({"params": state.engine_params}, x, return_reg_log=True,
                                     train=True, duals=state.duals, method="encode",
                                     rngs={"sample": jax.random.PRNGKey(2)})
            xrec = jb.module.apply({"params": state.engine_params}, z, train=False,
                                   method="decode")
            grads, _ = jax.grad(jb._disc_loss, has_aux=True)(
                state.loss_params["discriminator"], state, x, xrec)
            if knob:
                grads = _cast_reduce_grads(grads, mesh, jnp.bfloat16)
            return grads, jb._update_duals(state.duals, reg)

        fn = jax.jit(disc_grads, static_argnums=(2,))
        with jax.set_mesh(mesh):
            x2 = shard_batch(mesh, {"img": _joined(2)})["img"]
            g, duals = fn(state, x2, False)
            gk, _ = fn(state, x2, True)
        out["disc"] = _flat_grads(g, "loss.discriminator.")
        out["disc_duals"] = jax.tree.map(np.asarray, duals)
        out["knob"] = _flat_grads(gk, "loss.discriminator.")
    finally:
        mp.undo()
    return out


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _whole(grads) -> float:
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in grads.values())))


def _zero_grads(grads):
    """Names of the gradients that are zero in exact arithmetic."""
    whole = _whole(grads)
    return {k for k, g in grads.items() if np.linalg.norm(np.asarray(g)) < ZERO_REL * whole}


def _check_grads(got, want, bar):
    """Each gradient within ``bar`` relative L2 of ``want``'s; one that is
    zero in exact arithmetic under the same share of the whole."""
    assert set(got) == set(want)
    whole, zero = _whole(want), _zero_grads(want)
    assert set(want) - zero  # the check holds real gradients
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if k in zero:
            assert np.linalg.norm(g) < ZERO_REL * whole, k
        else:
            assert _rel(g, w) <= bar, k


def test_ranks_run_on_gloo_and_join_the_noise(runs):
    ranks, single = runs["ranks"], runs["single"]
    assert [r["backend"] for r in ranks] == ["gloo"] * WORLD
    # init draws the joined batch's eps on every rank; each step, a rank's rows
    for r, out in enumerate(ranks):
        rows = slice(r * PER_RANK, (r + 1) * PER_RANK)
        np.testing.assert_array_equal(out["eps"][0], single["eps"][0])
        for got, want in zip(out["eps"][1:], single["eps"][1:]):
            np.testing.assert_array_equal(got, want[rows])


@pytest.mark.parametrize("phase", ["ae", "disc"])
def test_reduced_gradients_equal_one_process_on_the_joined_batch(runs, phase):
    for out in runs["ranks"]:
        _check_grads(out[phase]["grads"], runs["single"][phase]["grads"], GRAD_REL_L2)


@pytest.mark.parametrize("phase", ["ae", "disc"])
def test_parameters_and_duals_after_each_step_equal_one_process(runs, phase):
    single = runs["single"]
    phases = ("ae",) if phase == "ae" else ("ae", "disc")
    zero = set().union(*(_zero_grads(single[p]["grads"]) for p in phases))
    for out in runs["ranks"]:
        for k, want in single[phase]["params"].items():
            got = out[phase]["params"][k]
            if k in zero:  # one update of float noise: at most the learning rate
                assert float((got - single["init"][k]).abs().max()) <= LR * (1 + 1e-3), k
            elif float(want.norm()) > 0:
                assert _rel(got.numpy(), want.numpy()) <= GRAD_REL_L2, k
            else:
                assert float(got.abs().max()) == 0.0, k
        for k, want in single[phase]["duals"].items():
            assert torch.equal(out[phase]["duals"][k], want), k


def test_ranks_hold_the_same_state_bit_for_bit(runs):
    a, b = runs["ranks"]
    for phase in ("ae", "disc"):
        for key in ("params", "duals", "grads"):
            for k in a[phase][key]:
                assert torch.equal(a[phase][key][k], b[phase][key][k]), (phase, key, k)
    for opt in ("ae", "disc"):
        for i, st in a["opt"][opt].items():
            for k, v in st.items():
                assert torch.equal(v, b["opt"][opt][i][k]), (opt, i, k)


@pytest.mark.parametrize("phase", ["ae", "disc"])
def test_reduced_gradients_match_the_jax_mesh_step(runs, phase):
    _check_grads(runs["ranks"][0][phase]["grads"], runs["jax"][phase], JAX_REL_L2)
    for k, w in runs["jax"][f"{phase}_duals"].items():
        np.testing.assert_allclose(float(runs["ranks"][0][phase]["duals"][k]), float(w),
                                   atol=DUAL_TOL)


def test_bf16_gradient_reduce_on_the_disc_phase_matches_jax(runs):
    want = runs["jax"]["knob"]
    plain = runs["ranks"][0]["disc"]["grads"]
    changed = False
    for out in runs["ranks"]:
        got = out["knob_grads"]
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            # a bf16 sum of bf16-rounded gradients, halved in float32
            summed = g * WORLD
            assert torch.equal(summed, summed.to(torch.bfloat16).float()), k
            assert _rel(g.numpy(), w) <= BF16_REL_L2, k
            changed |= not torch.equal(g, plain[k])
    assert changed, "the bf16 reduce changed nothing"


def test_uneven_validation_shards_give_the_one_process_mean(runs):
    want = runs["single"]["val"]
    assert want and "val/loss/rec" in want and "val/loss/disc" in want
    for out in runs["ranks"]:
        assert set(out["val"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(out["val"][k], w, rtol=1e-5, atol=1e-7, err_msg=k)


def test_mesh_specs_of_the_port():
    assert distributed.data_parallel_size(None) == 1
    assert distributed.data_parallel_size({"data": -1, "model": 1}) == 1
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        distributed.data_parallel_size({"data": -1, "model": 2})
    with pytest.raises(ValueError):
        distributed.data_parallel_size({"data": 2})


@pytest.mark.parametrize("loss_dtype,engine_dtype", [("float32", "float32"),
                                                      ("bfloat16", "float32"),
                                                      ("float32", "bfloat16")])
def test_grad_allreduce_dtype_skips_the_phases_jax_skips(loss_dtype, engine_dtype):
    """Phases that already compute in bf16 drop out of the knob, with the
    JAX package's warning, as its builder on a 2-device mesh decides."""
    import warnings

    import jax

    from vqvae_from_gaussian_vae_tpu import instantiate_from_config as jax_instantiate
    from vqvae_from_gaussian_vae_tpu.parallel.mesh import make_mesh
    from vqvae_from_gaussian_vae_tpu.parallel.train_state import (
        make_optimizers as jax_make_optimizers)
    from vqvae_from_gaussian_vae_tpu.parallel.train_step import TrainStepBuilder as JaxBuilder

    cfg = copy.deepcopy(CONFIG)
    cfg["params"]["loss_config"]["params"]["dtype"] = loss_dtype
    for key in ("encoder_config", "decoder_config"):
        cfg["params"][key]["params"] = dict(_UNET, dtype=engine_dtype)
    phases = ("ae", "disc")
    mesh = make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = JaxBuilder(jax_instantiate(copy.deepcopy(cfg)), *jax_make_optimizers(LR),
                          grad_allreduce_dtype="bfloat16", mesh=mesh,
                          grad_allreduce_phases=phases).grad_allreduce_phases
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = TrainStepBuilder(instantiate_from_config(cfg, device="cpu"), *make_optimizers(LR),
                               grad_allreduce_dtype="bfloat16",
                               grad_allreduce_phases=phases).grad_allreduce_phases
    assert got == want
    warned = [any("double the wire bytes" in str(w.message) for w in ws) for ws in (pw, jw)]
    assert warned[0] == warned[1] == (want != phases)
