"""The port's training logs and checkpoint bookkeeping against the JAX
package's: ``CSVLogger`` writes the same file for the same rows (the
``time`` column aside), ``_to_uint8_grid`` the same bytes, the
``ImageLogger`` the same schedule and image file names; the PiYG colormap
of the discriminator's logit grids is matplotlib's; and ``Checkpointer``
keeps the same names, the same set of snapshots and the same ``best.json``
as the JAX one (Orbax on a tiny pytree) over the same steps and values."""

import csv
import json
import os

import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.parallel import trainer as jtrainer
from vqvae_from_gaussian_vae_tpu.utils import loggers as jlog
from vqvae_from_gaussian_vae_tpu_torch.losses.discriminator_loss import piyg
from vqvae_from_gaussian_vae_tpu_torch.parallel import trainer as ptrainer
from vqvae_from_gaussian_vae_tpu_torch.utils import loggers as plog

ROWS = [({"train/loss/total": 1.5, "train/loss/nll": 0.25}, 0),
        ({"train/loss/total": 1.25, "train/loss/nll": 0.5}, 1),
        ({"train/loss/disc": 0.75, "train/logits/real": -0.125}, 1),  # new keys: rewrite
        ({"train/loss/total": 1.0, "train/loss/nll": 0.125, "lr": 1e-4}, 2),
        ({"train/loss/disc": 0.5}, 3)]


def _without_time(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    col = rows[0].index("time")
    return [r[:col] + r[col + 1:] for r in rows]


def test_csv_logger_writes_the_jax_file(tmp_path):
    jl, pl = jlog.CSVLogger(str(tmp_path / "jax")), plog.CSVLogger(str(tmp_path / "port"))
    for metrics, step in ROWS:
        jl.log(metrics, step)
        pl.log(dict(metrics), step)
        assert _without_time(pl.path) == _without_time(jl.path)
    assert len(_without_time(pl.path)) == 1 + len(ROWS)


@pytest.mark.parametrize("n,n_rows", [(8, 2), (5, 2), (3, 1), (1, 4)])
def test_uint8_grid_matches_jax(n, n_rows):
    imgs = np.random.default_rng(n).uniform(-1.2, 1.2, (n, 6, 5, 3)).astype(np.float32)
    got, want = plog._to_uint8_grid(imgs, n_rows), jlog._to_uint8_grid(imgs, n_rows)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"batch_frequency": 4, "increase_log_steps": False},
                                {"batch_frequency": 100, "log_first_step": False},
                                {"disabled": True}])
def test_image_logger_schedule_matches_jax(kw):
    jl, pl = jlog.ImageLogger(**kw), plog.ImageLogger(**kw)
    assert pl.log_steps == jl.log_steps
    assert [s for s in range(3000) if pl.should_log(s)] == \
        [s for s in range(3000) if jl.should_log(s)]


def test_image_logger_writes_the_jax_files(tmp_path):
    """The same grids under the same names, from an engine stand-in whose
    ``log_images`` gives torch tensors to the port's logger and numpy to
    the JAX one."""
    import torch

    imgs = np.random.default_rng(2).uniform(-1, 1, (6, 8, 8, 3)).astype(np.float32)

    class Engine:
        input_key = "img"

        def __init__(self, wrap):
            self.wrap = wrap

        def log_images(self, batch, **kw):
            x = batch["img"]
            return {"inputs": self.wrap(x), "reconstructions": self.wrap(-x)}

    batch = {"img": imgs}
    extra = {"vis_logits": imgs[:4] * 0.5}
    jgrids = jlog.ImageLogger(max_images=4).log_images(Engine(np.asarray), batch, 7,
                                                       str(tmp_path / "jax"), extra_images=extra)
    pgrids = plog.ImageLogger(max_images=4).log_images(Engine(torch.from_numpy), batch, 7,
                                                       str(tmp_path / "port"), extra_images=extra)
    assert sorted(pgrids) == sorted(jgrids)
    for key in jgrids:
        assert np.array_equal(pgrids[key], jgrids[key])
    names = sorted(os.listdir(tmp_path / "jax" / "images" / "train"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images" / "train"))
    assert "reconstructions_gs-000007.png" in names


def test_piyg_is_matplotlibs():
    from matplotlib import colormaps

    x = np.concatenate([np.random.default_rng(0).uniform(0, 1, 4000),
                        np.arange(257) / 256.0, [0.0, 1.0]])
    np.testing.assert_allclose(piyg(x), colormaps["PiYG"](x)[..., :3], rtol=0, atol=1e-12)


def test_wandb_logger_says_wandb_is_missing():
    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="wandb"):
            plog.WandbLogger("project", "run")
    else:
        pytest.skip("wandb is installed here")


class _State:
    """A stand-in train state: a step and one array."""

    def __init__(self, step):
        self.step = step
        self.w = np.full((3,), float(step), np.float32)


def _jax_state(step):
    import flax.struct
    import jax.numpy as jnp

    @flax.struct.dataclass
    class JaxState:
        step: jnp.ndarray
        w: jnp.ndarray

    return JaxState(jnp.int32(step), jnp.full((3,), float(step), jnp.float32))


def test_checkpointer_keeps_the_jax_names_and_best_ledger(tmp_path):
    import torch

    jc = jtrainer.Checkpointer(str(tmp_path / "jax"), every_n=3, keep_every_n=6)
    pc = ptrainer.Checkpointer(str(tmp_path / "port"),
                               lambda s: {"step": s.step, "w": torch.from_numpy(s.w)},
                               every_n=3, keep_every_n=6)
    values = {2: 0.5, 3: 0.75, 5: 0.25, 6: 0.25, 7: 0.125, 9: 0.9, 10: 0.0625}
    for step in range(1, 13):
        assert pc.save(_State(step)) == jc.save(_jax_state(step))
        if step in values:
            got = pc.save_best(_State(step), values[step], "val/loss/rec", top_k=3)
            assert got == jc.save_best(_jax_state(step), values[step], "val/loss/rec", top_k=3)
    assert pc.save(_State(12), name="last", force=True) == \
        jc.save(_jax_state(12), name="last", force=True)
    kept = sorted(os.listdir(pc.dir))
    assert kept == sorted(os.listdir(jc.dir))
    assert {"last", "step_00000006", "step_00000012", "best.json"} <= set(kept)
    with open(os.path.join(pc.dir, "best.json")) as f, \
            open(os.path.join(jc.dir, "best.json")) as g:
        assert json.load(f) == json.load(g)
    # every kept snapshot holds its own step's state
    for name in kept:
        if name != "best.json":
            blob = pc.restore(name)
            step = int(name.rsplit("_", 1)[1]) if name != "last" else 12
            assert blob["step"] == step and torch.equal(blob["w"], torch.full((3,), float(step)))
    assert pc.has("last") and not pc.has("step_00000007")
