"""The port's evaluation entry point in video mode (``python -m
vqvae_from_gaussian_vae_tpu_torch.eval --video --fvd``) on the CPU, against
the root ``eval.py`` of the JAX package.

Four seeded 9-frame 32x32 GIF clips (written with PIL), the tiny UNet + GQ
engine of ``tests/test_torch_eval_sweep.py`` (float32, 256 codes), ``--bs
2``: each batch of two clips folds into 18 frames for the tokenizer, and
the reconstructions fold back into clips for I3D (resized to 224).  The
engine, Inception, LPIPS and I3D weights are seeded port ``state_dict``s
that the JAX loaders read (``--ckpt``, ``--inception_weights``,
``--lpips_weights``, ``--i3d_weights``; I3D with BatchNorm statistics away
from identity).  The root ``eval.py`` runs as a subprocess with
``JAX_PLATFORMS=cpu`` while the port sweeps in this process.  Both print
the same summary: PSNR, SSIM and LPIPS within 1e-4 relative, FID and FVD
within 1e-3 relative (beside the 4-decimal print's own rounding), the
frame count and the codebook usage equal.  The root ``eval.py``'s guards
are errors here too.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_eval_sweep import LINES, PRINT_STEP, REPO, _engine_cfg, _parse
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config
from vqvae_from_gaussian_vae_tpu_torch.evaluations import i3d, inception
from vqvae_from_gaussian_vae_tpu_torch.evaluations.lpips_metric import LPIPSAlex, seed_weights

CLIPS, FRAMES, SIZE = 4, 9, 32
VIDEO_LINES = dict(LINES, fvd=r"^FVD: (\S+)")
BARS = {"psnr": 1e-4, "ssim": 1e-4, "lpips": 1e-4, "fid": 1e-3, "fvd": 1e-3}


def write_clips(folder, n=CLIPS, frames=FRAMES, size=SIZE, seed=12):
    """Seeded GIF clips: a drifting gradient plus noise, so frames differ."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    for c in range(n):
        base = rng.uniform(0, 255, 3)
        imgs = []
        for t in range(frames):
            ramp = (xx * (3 + c) + yy * 2 + 9 * t) % 256
            arr = (0.6 * ramp[..., None] + 0.4 * base
                   + rng.integers(0, 40, (size, size, 3))).clip(0, 255).astype(np.uint8)
            imgs.append(Image.fromarray(arr))
        imgs[0].save(os.path.join(folder, f"clip_{c:02d}.gif"), save_all=True,
                     append_images=imgs[1:], duration=40, loop=0)


def i3d_state_dict(seed=13):
    """A seeded I3D ``state_dict`` with BatchNorm affine and statistics away
    from identity, the convs at He scale (sqrt(2) over the seeded 1 /
    fan_in) so that the logits, and so FVD, keep their size through the
    trunk's ReLUs."""
    net = i3d.InceptionI3d()
    i3d.seed_weights(net, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if t.dim() == 5:
                t.mul_(2 ** 0.5)
            elif name.endswith("running_mean") or name.endswith("bn.bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var") or name.endswith("bn.weight"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return net.state_dict()


# the root eval.py with flax's ``Module.init`` giving zero arrays of
# ``jax.eval_shape``'s shapes: its un-jitted inits run the I3D forward at (1, 9,
# 224, 224, 3) op by op (some 40 s on the CPU), and every template it builds is
# overwritten by a weights file (a weight left out would show as a difference)
SHAPE_INIT_RUNNER = """
import runpy, sys
import flax.linen as nn
import jax
import numpy as np
real = nn.Module.init
def init(self, rngs, *args, **kwargs):
    shapes = jax.eval_shape(lambda: real(self, rngs, *args, **kwargs))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
nn.Module.init = init
sys.argv = ["eval.py"] + sys.argv[1:]
runpy.run_path("eval.py", run_name="__main__")
"""


def _rel_close(a, b, rel):
    return abs(a - b) <= rel * abs(b) + PRINT_STEP


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("video_sweep")
    cfg_path, clips = str(tmp / "tiny.yaml"), str(tmp / "clips")
    cfg = _engine_cfg(cfg_path)
    write_clips(clips)
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
    paths = {k: str(tmp / f"{k}.pth") for k in ("inception", "lpips", "i3d")}
    torch.save(net.state_dict(), paths["inception"])
    torch.save(lp.state_dict(), paths["lpips"])
    torch.save(i3d_state_dict(), paths["i3d"])
    common = ["--base", cfg_path, "--dataset", clips, "--img_size", str(SIZE), "--bs", "2",
              "--ckpt", ckpt, "--inception_weights", paths["inception"],
              "--lpips_weights", paths["lpips"], "--video", "--fvd",
              "--num_frames", str(FRAMES), "--i3d_weights", paths["i3d"]]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    jax_run = subprocess.Popen([sys.executable, "-c", SHAPE_INIT_RUNNER, *common],
                               cwd=REPO, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = port_eval.main([*common, "--device", "cpu"])
        jax_out = jax_run.communicate(timeout=600)[0]
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, jax_out[-3000:]
    parse = lambda out: {**_parse(out), **_fvd(out)}  # noqa: E731
    return {"port": parse(buf.getvalue()), "jax": parse(jax_out), "result": result,
            "common": common}


def _fvd(out):
    import re

    m = re.search(VIDEO_LINES["fvd"], out, re.MULTILINE)
    assert m, f"FVD missing from the summary:\n{out[-3000:]}"
    return {"fvd": (float(m.group(1)),)}


def test_the_port_prints_the_root_eval_video_summary(sweep):
    got, want = sweep["port"], sweep["jax"]
    assert got["count"][0] == want["count"][0] == CLIPS * FRAMES
    assert got["usage"] == want["usage"]
    assert np.isnan(got["msssim"][0]) and np.isnan(want["msssim"][0])
    for key, rel in BARS.items():
        for a, b in zip(got[key], want[key]):
            assert _rel_close(a, b, rel), (key, got[key], want[key])
    assert want["fvd"][0] > 0


def test_the_video_sweep_returns_its_rows(sweep):
    res = sweep["result"]
    assert res["count"] == CLIPS * FRAMES and res["world"] == 1
    assert res["feat_x"].shape == (CLIPS * FRAMES, 2048)
    assert res["hist"].sum() == CLIPS * FRAMES * 16 * 16
    assert np.isfinite(res["fvd"]) and res["fvd"] > 0


@pytest.mark.parametrize("flags,match", [
    (["--save", "True"], "--save"),
    (["--num_frames", "8"], ">= 9 frames"),
])
def test_the_root_eval_guards_are_errors(sweep, flags, match):
    argv = [a for a in sweep["common"] if a not in ("--num_frames", str(FRAMES))]
    with pytest.raises(SystemExit, match=match):
        port_eval.main([*argv, *flags, "--device", "cpu"])


def test_fvd_is_refused_on_more_than_one_rank(monkeypatch, sweep):
    from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "world", lambda: 2)
    with pytest.raises(SystemExit, match="one rank|one process"):
        port_eval.main([*sweep["common"], "--device", "cpu"])
