"""The port's evaluation entry point (``python -m
vqvae_from_gaussian_vae_tpu_torch.eval``) on the CPU, against the root
``eval.py`` of the JAX package.

Eight seeded 32x32 images, the tiny UNet + GQ engine of
``tests/test_eval_multihost.py`` (float32, 256 codes), ``--bs 2``.  The
engine's weights are a seeded port ``state_dict`` (``--ckpt``, which the
JAX engine's ``load_checkpoint`` reads), and Inception and LPIPS load
seeded port ``state_dict``s (``--inception_weights``, ``--lpips_weights``)
that the JAX loaders read too.  The port sweeps once in this process on
one rank and once under ``torchrun --nproc_per_node 2`` on two gloo ranks
(writing ``--stats_cache`` and ``--save``-ing each rank's images); the root ``eval.py`` runs as a subprocess with
``JAX_PLATFORMS=cpu`` on one CPU device.  Every run prints the same
summary: PSNR, SSIM, LPIPS and FID within 1e-4 relative (beside the
4-decimal print's own rounding), MS-SSIM NaN at 32 pixels, the image count
and the codebook usage and entropy equal.
"""

import contextlib
import io
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.evaluations import inception
from vqvae_from_gaussian_vae_tpu_torch.evaluations.lpips_metric import LPIPSAlex, seed_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "vqvae_from_gaussian_vae_tpu"
REL = 1e-4
PRINT_STEP = 1e-4  # the summary prints 4 decimals
LINES = {
    "psnr": r"^PSNR: (\S+) \(±(\S+)\)",
    "ssim": r"^SSIM: (\S+) \(±(\S+)\)",
    "msssim": r"^MS-SSIM: (\S+) \(±(\S+)\)",
    "lpips": r"^LPIPS \(AlexNet\): (\S+) \(±(\S+)\)",
    "fid": r"^FID: (\S+)",
    "count": r"^evaluated (\d+) images on (\d+) device",
    "usage": r"^codebook usage: (\S+)%  entropy: (\S+) bits",
}


def _engine_cfg(path):
    unet = {"attn_type": "vanilla", "double_z": True, "z_channels": 4, "resolution": 32,
            "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
            "attn_resolutions": [], "dropout": 0.0}
    cfg = {"model": {
        "target": f"{PKG}.models.autoencoder.AutoencodingEngine",
        "params": {
            "input_key": "img", "loss_config": None,
            "regularizer_config": {
                "target": f"{PKG}.quantization.gaussian.GaussianQuantRegularizer",
                "params": {"format": "bchw", "group": 4, "n_samples": 256, "seed": 7,
                           "backend": "xla"},
            },
            "encoder_config": {"target": f"{PKG}.models.unet.Encoder", "params": unet},
            "decoder_config": {"target": f"{PKG}.models.unet.Decoder", "params": dict(unet)},
        },
    }}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


def _images(folder, n=8, size=32):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n):
        arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, f"img_{i:02d}.png"))


def _parse(out: str):
    got = {}
    for key, pat in LINES.items():
        m = re.search(pat, out, re.MULTILINE)
        assert m, f"{key} missing from the summary:\n{out[-3000:]}"
        got[key] = tuple(float(v) for v in m.groups())
    return got


def _close(a: float, b: float) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= REL * abs(b) + PRINT_STEP


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    cfg_path, images = str(tmp / "tiny.yaml"), str(tmp / "images")
    cfg = _engine_cfg(cfg_path)
    _images(images)
    engine = instantiate_from_config(cfg["model"], device="cpu", seed=4)
    ckpt = str(tmp / "engine.pt")
    engine.save_params(ckpt)
    net = inception.InceptionV3()
    inception.seed_weights(net, 5)
    lp = LPIPSAlex()
    seed_weights(lp, 3)
    with torch.no_grad():
        for k in range(5):
            getattr(lp, f"lin{k}").model[1].weight.abs_()
    inc_path, lp_path = str(tmp / "inception.pth"), str(tmp / "alex.pth")
    torch.save(net.state_dict(), inc_path)
    torch.save(lp.state_dict(), lp_path)
    common = ["--base", cfg_path, "--dataset", images, "--img_size", "32", "--bs", "2",
              "--ckpt", ckpt, "--inception_weights", inc_path, "--lpips_weights", lp_path]
    stats = str(tmp / "stats.npz")

    # the root eval.py builds its models by flax's un-jitted init, some 500
    # small programs that XLA compiles one by one; its LLVM passes at level 0
    # halve that compile and leave the printed summary as it is
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    jax_run = subprocess.Popen([sys.executable, os.path.join(REPO, "eval.py"), *common],
                               cwd=REPO, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    two = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "vqvae_from_gaussian_vae_tpu_torch.eval", *common, "--device", "cpu",
         "--stats_cache", stats, "--save", "True", "--save_dir", str(tmp / "saved")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            one_result = port_eval.main([*common, "--device", "cpu"])
        two_out = two.communicate(timeout=600)[0]
        jax_out = jax_run.communicate(timeout=600)[0]
    finally:
        for p in (two, jax_run):
            if p.poll() is None:
                p.kill()
    assert two.returncode == 0, two_out[-3000:]
    assert jax_run.returncode == 0, jax_out[-3000:]
    return {"one": _parse(buf.getvalue()), "one_result": one_result, "two": _parse(two_out),
            "two_out": two_out, "jax": _parse(jax_out), "saved": tmp / "saved", "stats": stats}


@pytest.mark.parametrize("run", ["one", "two"])
def test_the_port_prints_the_root_eval_summary(sweeps, run):
    got, want = sweeps[run], sweeps["jax"]
    assert got["count"][0] == want["count"][0] == 8
    assert got["count"][1] == (1 if run == "one" else 2)
    assert got["usage"] == want["usage"]
    for key in ("psnr", "ssim", "msssim", "lpips", "fid"):
        for a, b in zip(got[key], want[key]):
            assert _close(a, b), (key, got[key], want[key])


def test_two_ranks_write_the_stats_cache_and_save_their_rows(sweeps):
    assert "(source stats cached to" in sweeps["two_out"]
    assert os.path.exists(sweeps["stats"])
    for sub in ("src", "rec"):
        assert len(os.listdir(sweeps["saved"] / sub)) == 8


def test_the_sweep_returns_its_rows(sweeps):
    res = sweeps["one_result"]
    assert res["count"] == 8 and res["world"] == 1
    assert res["feat_x"].shape == res["feat_r"].shape == (8, 2048)
    assert res["hist"].sum() == 8 * 16 * 16 and res["hist"].shape == (65536,)
    assert np.isfinite(res["psnr"]).all() and np.isnan(res["msssim"]).all()


def test_video_flags_name_what_is_not_ported(tmp_path):
    """The video flags, no longer refused: the root ``eval.py``'s defaults,
    and ``--video`` reads the folder as clips (an image folder holds none)."""
    args = port_eval.get_parser().parse_args(["--base", "x.yaml", "--dataset", "d"])
    assert (args.video, args.num_frames, args.fvd, args.i3d_weights) == (False, 16, False, "")
    _images(str(tmp_path / "images"), n=2)
    _engine_cfg(str(tmp_path / "tiny.yaml"))
    for flags in (["--video"], ["--video", "--fvd", "--num_frames", "9"]):
        with pytest.raises(ValueError, match="Clip list is empty"):
            port_eval.main(["--base", str(tmp_path / "tiny.yaml"), "--dataset",
                            str(tmp_path / "images"), "--img_size", "32", "--device", "cpu",
                            *flags])


def test_batch_position_probe_names_the_first_module_that_depends_on_position():
    """The card tool behind the smoke's shard-ordered one-rank sweep
    (``labs/batch_position_probe.py``), on a model whose middle module
    adds its batch position."""
    from vqvae_from_gaussian_vae_tpu_torch.labs.batch_position_probe import probe

    class AddsPosition(torch.nn.Module):
        def forward(self, x):
            return x + 1e-3 * torch.arange(len(x), dtype=x.dtype).reshape(-1, 1)

    torch.manual_seed(0)
    enc = torch.nn.Sequential(torch.nn.Linear(4, 4), AddsPosition(), torch.nn.Linear(4, 4))
    x = torch.randn(4, 4)
    out = probe(enc, x, torch.roll(torch.arange(4), 1))
    assert out["compared"] == 3 and out["differing"] == 2
    assert out["first"]["module"] == "1" and out["first"]["positions"] == [0, 1, 2, 3]
    assert probe(enc[:1], x, torch.roll(torch.arange(4), 1))["differing"] == 0
