"""The port's training entry point on the CPU.

- The CLI (``python -m vqvae_from_gaussian_vae_tpu_torch.main``, driven
  in-process through ``main(argv)`` with ``--device cpu``) on the tiny YAML
  of ``tests/test_harness.py``, formatted with the JAX package's name as
  that test does: the registry maps its JAX targets and the GQ regularizer
  takes ``backend: xla`` as a plain backend.  The artefacts
  ``test_harness.py`` asserts of the JAX CLI (``checkpoints/last``,
  ``step_00000004``, ``metrics.csv`` with the ae and disc losses,
  ``configs/merged.yaml``, reconstruction images), then a resume from 6 to
  8 that writes ``step_00000008`` (under ``--profile``, which writes its
  trace).  ``--lpips_weights`` installs a seeded ``vgg.pth`` in the
  reference's key names, giving the perceptual net the weights the JAX
  package's ``load_lpips_weights`` gives.
- Resume is exact: 8 straight steps against 4 steps, the forced save at the
  end of ``fit``, a new engine and ``Trainer`` with ``resume=True`` and 4
  more: every tensor of the state (parameters, Adam moments, duals,
  ``logvar``, ActNorm, the generator) and the scalar rows of steps 4-7
  (``time`` and ``imgs_per_sec`` aside) bit-equal in float32.  The trainer
  restarts its loader and the batch parity on resume, as the JAX one does,
  so the run resumes at an even step on a folder of identical images, where
  both runs see the same batches.
- ``load_checkpoint``'s weights-only read of a trainer checkpoint and of a
  Lightning-style blob; the CLI's refusals and its TF32 switch.
"""

import copy
import csv
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests.test_harness import TINY_MODEL_YAML
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqvae_from_gaussian_vae_tpu.losses.lpips import load_lpips_weights as jax_load_lpips
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
from vqvae_from_gaussian_vae_tpu_torch import main as port_main
from vqvae_from_gaussian_vae_tpu_torch.losses.lpips import VGG_CFG
from vqvae_from_gaussian_vae_tpu_torch.parallel.trainer import Trainer, read_checkpoint
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

PKG = "vqvae_from_gaussian_vae_tpu"


def _images(folder, n, same: bool):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    first = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
    for i in range(n):
        arr = first if same else rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, f"img_{i:03d}.png"))
    return folder


def _vgg_pth(path):
    """A seeded LPIPS checkpoint in the reference's key names: the VGG
    trunk as ``net.slice{s}.{n}``, the heads ``lin{k}.model.1.weight`` and
    the scaling layer's buffers."""
    gen = torch.Generator().manual_seed(11)
    slices = {0: 1, 2: 1, 5: 2, 7: 2, 10: 3, 12: 3, 14: 3, 17: 4, 19: 4, 21: 4, 24: 5, 26: 5,
              28: 5}
    sd, cin = {}, 3
    for idx, width in VGG_CFG:
        sd[f"net.slice{slices[idx]}.{idx}.weight"] = 0.05 * torch.randn(
            (width, cin, 3, 3), generator=gen)
        sd[f"net.slice{slices[idx]}.{idx}.bias"] = 0.1 * torch.randn((width,), generator=gen)
        cin = width
    for k, ch in enumerate((64, 128, 256, 512, 512)):
        sd[f"lin{k}.model.1.weight"] = torch.rand((1, ch, 1, 1), generator=gen)
    sd["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1)
    sd["scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1)
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The tiny YAML through ``main`` for 6 steps with ``--lpips_weights``,
    then ``--resume`` to 8 under ``--profile``."""
    tmp = tmp_path_factory.mktemp("cli")
    root = _images(str(tmp / "imgs"), 24, same=False)
    cfg_path = tmp / "tiny.yaml"
    cfg_path.write_text(TINY_MODEL_YAML.format(pkg=PKG, root=root))
    vgg = _vgg_pth(tmp / "vgg.pth")
    logroot = tmp / "logs"
    first = port_main.main(["--base", str(cfg_path), "--logdir", str(logroot), "--name", "tiny",
                            "--no-test", "--device", "cpu", "--lpips_weights", vgg])
    runs = list(logroot.iterdir())
    assert len(runs) == 1
    run = runs[0]
    state = {"first": first, "run": run, "vgg": vgg, "logs_after_first": {
        "csv": (run / "metrics.csv").read_text(),
        "checkpoints": sorted(os.listdir(run / "checkpoints"))}}
    state["resumed"] = port_main.main(["--resume", str(run), "--no-test", "--device", "cpu",
                                       "--profile", "training.trainer.max_steps=8"])
    return state


def test_cli_trains_and_writes_the_jax_clis_artefacts(cli):
    run = cli["run"]
    assert {"last", "step_00000004"} <= set(cli["logs_after_first"]["checkpoints"])
    assert (run / "configs" / "merged.yaml").exists()
    merged = yaml.safe_load((run / "configs" / "merged.yaml").read_text())
    assert merged["model"]["target"] == f"{PKG}.models.autoencoder.AutoencodingEngine"
    images = os.listdir(run / "images" / "train")
    assert any("reconstructions" in p for p in images) and "vis_logits_gs-000004.png" in images
    text = cli["logs_after_first"]["csv"]
    assert "train/loss/total" in text and "train/loss/disc" in text
    rows = list(csv.DictReader(text.splitlines()))
    assert [int(r["step"]) for r in rows] == list(range(6))
    for r in rows:
        assert r["lr"] == "0.0001" and float(r["imgs_per_sec"]) > 0
        assert all(np.isfinite(float(r[k])) for k in ("duals/lam", "duals/lam_min",
                                                      "duals/lam_max"))
        assert np.isfinite(float(r["train/loss/total" if r["train/loss/total"] else
                                   "train/loss/disc"]))
    # phase by batch parity from step 0 (disc_start_iter 0); the disc term
    # (adaptive weight) from the loss's disc_start 2
    assert [bool(r["train/loss/total"]) for r in rows] == [True, False] * 3
    assert float(rows[0]["train/scalars/d_weight"]) == 0.0
    assert float(rows[4]["train/scalars/d_weight"]) > 0.0
    assert cli["first"].state.step == 6 and cli["first"].data.loader_kind in ("native", "python")


def test_cli_resumes_from_6_to_8(cli):
    run, resumed = cli["run"], cli["resumed"]
    assert (run / "checkpoints" / "step_00000008").exists()
    assert resumed.state.step == 8 and read_checkpoint(str(run / "checkpoints" / "last"))[
        "step"] == 8
    rows = list(csv.DictReader((run / "metrics.csv").read_text().splitlines()))
    assert [int(r["step"]) for r in rows] == [6, 7]
    assert (run / "trace" / "trace.json").exists()


def test_lpips_weights_flag_installs_the_jax_weights(cli):
    """``--lpips_weights``: the port's perceptual net holds what the JAX
    package's ``load_lpips_weights`` makes of the same file."""
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda x: JaxLPIPS().init(jax.random.PRNGKey(0), x, x)["params"],
        jnp.zeros((1, 32, 32, 3))))
    params, missing, _ = jax_load_lpips(template, cli["vgg"])
    assert not missing
    want = state_dict_from_jax({"perceptual_loss": params})
    got = cli["first"].engine.loss.state_dict()
    assert len(want) == 26 + 5
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_engine_loads_a_trainer_checkpoint_and_a_lightning_blob(cli, tmp_path):
    """``load_checkpoint`` reads a port trainer checkpoint directory and a
    Lightning-style ``.ckpt`` with ``weights_only=True``; a blob that
    pickles any other class is refused."""
    cfg = load_config(str(cli["run"] / "configs" / "merged.yaml"))
    engine = instantiate_from_config(cfg["model"], device="cpu", seed=5)
    ckpt = str(cli["run"] / "checkpoints" / "last")
    missing, _ = engine.load_checkpoint(ckpt)
    saved = read_checkpoint(ckpt)["engine"]
    assert not missing and all(torch.equal(engine.state_dict()[k], saved[k]) for k in saved)

    other = instantiate_from_config(cfg["model"], device="cpu", seed=9)
    blob = {"state_dict": {**{k: v.clone() for k, v in other.state_dict().items()},
                           "loss.logvar": torch.zeros(())},
            "optimizer_states": [{"state": {0: {"step": torch.tensor(3.0)}},
                                  "param_groups": [{"lr": 1e-4, "params": [0]}]}],
            "lr_schedulers": [], "epoch": 2, "global_step": 1000,
            "pytorch-lightning_version": "2.1.0", "hyper_parameters": {"lr": 1e-4},
            "callbacks": {"ModelCheckpoint": {"best_model_score": torch.tensor(0.5)}}}
    torch.save(blob, tmp_path / "ref.ckpt")
    missing, unexpected = engine.load_checkpoint(str(tmp_path / "ref.ckpt"))
    assert not missing and not unexpected
    assert all(torch.equal(engine.state_dict()[k], v) for k, v in other.state_dict().items())
    blob["hyper_parameters"] = copy.copy(cfg)  # a plain dict still loads
    torch.save(blob, tmp_path / "ref2.ckpt")
    engine.load_checkpoint(str(tmp_path / "ref2.ckpt"))
    blob["hyper_parameters"] = np.random.default_rng(0)  # a class outside the allow-list
    torch.save(blob, tmp_path / "ref3.ckpt")
    with pytest.raises(pickle.UnpicklingError):
        engine.load_checkpoint(str(tmp_path / "ref3.ckpt"))


def test_cli_refuses_what_the_port_lacks(tmp_path):
    with pytest.raises(SystemExit):
        port_main.main([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_main.main(["--base", "configs/sd3unet_gq_0.25.yaml"])
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        Trainer(None, None, mesh_spec={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="process group has 1"):
        Trainer(None, None, mesh_spec={"data": 4})
    with pytest.raises(NotImplementedError):
        instantiate_from_config({"target": f"{PKG}.models.wan.AutoencoderKLWan", "params": {}})
    port_main._set_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    port_main._set_matmul_precision("high")
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    port_main._set_matmul_precision("highest")


# ------------------------------------------------------------------ resume


def _resume_engine_and_data(root):
    cfg = yaml.safe_load(TINY_MODEL_YAML.format(pkg=PKG, root=root))
    cfg["model"]["params"]["encoder_config"]["params"]["attn_resolutions"] = [16]
    cfg["data"]["params"].update(batch_size=2, num_workers=1, use_native=False)
    engine = instantiate_from_config(cfg["model"], device="cpu", seed=3)
    return engine, instantiate_from_config(cfg["data"])


def _trainer(logdir, root, max_steps):
    engine, data = _resume_engine_and_data(root)
    return Trainer(engine, data, logdir=logdir, max_steps=max_steps, log_every_n_steps=1,
                   seed=4, image_logger_cfg={"disabled": True},
                   checkpoint_cfg={"every_n_train_steps": 0, "keep_every_n_train_steps": 0})


def _rows(path):
    rows = list(csv.DictReader(open(path)))
    return {int(r["step"]): {k: v for k, v in r.items() if k not in ("time", "imgs_per_sec")}
            for r in rows}


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    root = _images(str(tmp / "same"), 4, same=True)
    straight = _trainer(str(tmp / "straight"), root, 8)
    straight.fit()
    half = _trainer(str(tmp / "half"), root, 4)
    half.fit()
    again = _trainer(str(tmp / "half"), root, 8)
    again.fit(resume=True)
    return straight, again, tmp


def test_resume_restores_and_continues_bit_for_bit(resumed):
    straight, again, tmp = resumed
    assert straight.state.step == again.state.step == 8
    a = straight.checkpoint_payload(straight.state)
    b = again.checkpoint_payload(again.state)
    assert a.keys() == b.keys() and a["step"] == b["step"]
    for part in ("engine", "loss", "duals"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert any("loc" in k for k in a["loss"]) and "logvar" in a["loss"]
    assert torch.equal(a["generator"], b["generator"])
    for opt in ("ae_opt", "disc_opt"):
        sa, sb = a[opt]["state"], b[opt]["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for i in sa:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[i][k], sb[i][k]), (opt, i, k)
    rows_a = _rows(tmp / "straight" / "metrics.csv")
    rows_b = _rows(tmp / "half" / "metrics.csv")
    assert sorted(rows_b) == [4, 5, 6, 7]
    for step in range(4, 8):
        assert rows_b[step] == rows_a[step], step
