"""The port's video pieces against the JAX package's, on the CPU: the clip
datasets (``data/video.py``) and the loader's ``"video"`` batches, bit-equal
on seeded GIFs written with PIL; the loss head's video branch (``rec_loss``
at ``dims=3``) within 1e-4; the I3D feature net (``evaluations/i3d.py``)
with the port's seeded weights (BatchNorm affine and statistics away from
identity) carried into the JAX net by its own ``load_i3d_weights`` and
back by ``state_dict_from_jax``, within ``tests/test_i3d.py``'s 2e-4 at
(1, 9, 224, 224, 3) and through the 224 resize; and FVD
(``evaluations/fvd.py``) within 1e-4 relative.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from tests.test_torch_video_eval import i3d_state_dict, write_clips
from vqvae_from_gaussian_vae_tpu.data import dataset as jax_dataset
from vqvae_from_gaussian_vae_tpu.data import video as jax_video
from vqvae_from_gaussian_vae_tpu.evaluations import fvd as jax_fvd
from vqvae_from_gaussian_vae_tpu.evaluations import i3d as jax_i3d
from vqvae_from_gaussian_vae_tpu.losses.discriminator_loss import (
    GeneralLPIPSWithDiscriminator as JaxLoss)
from vqvae_from_gaussian_vae_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqvae_from_gaussian_vae_tpu_torch.data import dataset as port_dataset
from vqvae_from_gaussian_vae_tpu_torch.data import video as port_video
from vqvae_from_gaussian_vae_tpu_torch.evaluations import fvd, i3d
from vqvae_from_gaussian_vae_tpu_torch.losses.discriminator_loss import (
    GeneralLPIPSWithDiscriminator)
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

I3D_TOL = 2e-4  # tests/test_i3d.py's bar
DISC = {"target": "vqvae_from_gaussian_vae_tpu.losses.discriminator.NLayerDiscriminator",
        "params": {"input_nc": 3, "ndf": 8, "n_layers": 2, "use_actnorm": False}}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    write_clips(str(root), n=2, frames=5, size=32, seed=21)
    nested = root / "nested"
    write_clips(str(nested), n=1, frames=3, size=40, seed=22)  # 3 frames: loop-padded
    from PIL import Image  # a non-square clip: resized on its short side, center-cropped

    rng = np.random.default_rng(23)
    frames = [Image.fromarray(rng.integers(0, 256, (30, 48, 3), dtype=np.uint8))
              for _ in range(6)]
    frames[0].save(root / "wide.GIF", save_all=True, append_images=frames[1:], duration=40)
    return root


@pytest.mark.parametrize("size,num_frames,stride", [(32, 5, 1), (24, 7, 2), (16, 2, 3)])
def test_load_video_is_bit_equal_to_jax(clips, size, num_frames, stride):
    paths = sorted(str(p) for p in clips.rglob("*") if p.suffix.lower() == ".gif")
    assert len(paths) == 4
    for path in paths:
        got = port_video.load_video(path, size, num_frames, stride)
        want = jax_video.load_video(path, size, num_frames, stride)
        assert got.dtype == np.float32 and got.shape == (num_frames, size, size, 3)
        np.testing.assert_array_equal(got, want)


def test_video_dataset_and_loader_are_bit_equal_to_jax(clips, tmp_path):
    port = port_video.VideoDataset(str(clips), image_size=32, num_frames=5)
    ref = jax_video.VideoDataset(str(clips), image_size=32, num_frames=5)
    assert port.fpaths == ref.fpaths and len(port) == 4
    listing = tmp_path / "clips.txt"
    listing.write_text("\n".join(ref.fpaths[::-1]) + "\n")
    assert port_video.VideoDataset(str(listing), 32, 5).fpaths == ref.fpaths[::-1]
    for i in range(len(port)):
        a, b = port[i], ref[i]
        assert a["fpath"] == b["fpath"]
        np.testing.assert_array_equal(a["video"], b["video"])
        np.testing.assert_array_equal(a["img"], a["video"][0])
    got = list(port_dataset._PrefetchLoader(port, 2, shuffle=False, drop_last=True))
    want = list(jax_dataset._PrefetchLoader(ref, 2, shuffle=False, drop_last=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["video"].shape == (2, 5, 32, 32, 3) and g["fpath"] == w["fpath"]
        np.testing.assert_array_equal(g["video"], np.asarray(w["video"]))
        np.testing.assert_array_equal(g["img"], np.asarray(w["img"]))
    with pytest.raises(ValueError, match="empty"):
        port_video.VideoDataset(str(tmp_path / "none"), 32)


def test_image_dataset_repeats_stills_as_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(24)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)).save(
            tmp_path / f"im{i}.png")
    for frames in (1, 3):
        port = port_video.ImageDataset(str(tmp_path), 16, num_frames=frames)
        ref = jax_video.ImageDataset(str(tmp_path), 16, num_frames=frames)
        for i in range(2):
            a, b = port[i], ref[i]
            assert a.keys() == b.keys() and ("video" in a) == (frames > 1)
            for k in ("img", "video"):
                if k in a:
                    np.testing.assert_array_equal(a[k], b[k])


def test_mp4_without_imageio_raises_as_jax(monkeypatch, tmp_path):
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "imageio.v3", None)  # an import that fails
    with pytest.raises(RuntimeError) as got:
        port_video.load_video(str(path), 16, 4)
    with pytest.raises(RuntimeError) as want:
        jax_video.load_video(str(path), 16, 4)
    assert str(got.value) == str(want.value) and "imageio" in str(got.value)


def test_video_rec_loss_matches_jax():
    """``dims=3``: frames fold into the batch for LPIPS, each frame's
    distance broadcasts over its pixels."""
    rng = np.random.default_rng(25)
    x = rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    port = GeneralLPIPSWithDiscriminator(disc_start=0, dims=3, perceptual_weight=0.7,
                                         discriminator_config=DISC)
    jloss = JaxLoss(disc_start=0, dims=3, perceptual_weight=0.7)
    flat = jnp.asarray(x[:, 0])
    lp_params = jax.jit(lambda a: JaxLPIPS().init(jax.random.PRNGKey(1), a, a))(flat)["params"]
    # heads 1e3 times the seeded ones: the perceptual term near the L1 term's size
    lp_params = {k: jax.tree.map(lambda a: 1e3 * abs(a), v) if k.startswith("lin") else v
                 for k, v in lp_params.items()}
    port.perceptual_loss.load_state_dict(state_dict_from_jax(lp_params), strict=True)
    params = {"perceptual_loss": lp_params, "logvar": jnp.zeros(())}
    want = jax.jit(lambda p, a, b: jloss.apply({"params": p}, a, b, method="rec_loss"))(
        params, jnp.asarray(x), jnp.asarray(y))
    got = port.rec_loss(torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(got.shape) == want.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    per_frame = got - torch.abs(torch.from_numpy(x) - torch.from_numpy(y))
    assert float(per_frame.min()) > 0.05
    torch.testing.assert_close(per_frame, per_frame[..., :1, :1, :1].expand_as(per_frame),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def i3d_pair():
    sd = i3d_state_dict(seed=31)
    port = i3d.InceptionI3d()
    assert i3d.load_i3d_weights(port, sd) == ([], [])
    port.eval()
    model = jax_i3d.InceptionI3d()
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 224, 224, 3)))))
    variables, missing, unexpected = jax_i3d.load_i3d_weights(template, sd)
    assert missing == [] and unexpected == []
    return port, model, variables, sd


def test_i3d_weights_cross_both_ways(i3d_pair):
    port, model, variables, sd = i3d_pair
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in port.parameters()) == 12697264
    back = state_dict_from_jax(variables)
    own = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert back.keys() == own.keys()
    assert all(torch.equal(back[k], own[k]) for k in own)
    prefixed = {f"module.{k}": v for k, v in sd.items()}  # a DataParallel checkpoint's names
    assert i3d.load_i3d_weights(i3d.InceptionI3d(), prefixed) == ([], [])


def test_i3d_matches_jax_at_224(i3d_pair):
    port, model, variables, _ = i3d_pair
    x = np.random.default_rng(32).standard_normal((1, 9, 224, 224, 3)).astype(np.float32) * 0.5
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (1, 400)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=I3D_TOL, atol=I3D_TOL)


def test_i3d_feature_fn_resizes_as_jax(i3d_pair):
    """Frames below 224 go through the bilinear resize without antialias."""
    _, _, variables, sd = i3d_pair
    x = np.random.default_rng(33).uniform(-1, 1, (2, 9, 40, 40, 3)).astype(np.float32)
    got = i3d.make_i3d_feature_fn(sd, resize=True, device="cpu")(x)
    want = jax_i3d.make_i3d_feature_fn(variables, resize=True)(x)
    assert got.shape == (2, 400) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=I3D_TOL, atol=I3D_TOL)
    with pytest.raises(ValueError, match="at least 9 frames"):
        i3d.make_i3d_feature_fn(sd, resize=True, device="cpu")(x[:, :8])


def test_fvd_matches_jax():
    rng = np.random.default_rng(34)
    real = [rng.standard_normal((6, 2, 4, 4, 3)).astype(np.float32) for _ in range(3)]
    fake = [0.8 * v + 0.2 for v in real]
    feature_fn = lambda v: np.asarray(v).reshape(len(v), -1)[:, :24]  # noqa: E731
    got = fvd.compute_fvd(real, fake, feature_fn=feature_fn)
    want = jax_fvd.compute_fvd(real, fake, feature_fn=feature_fn)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert abs(fvd.compute_fvd(real, real, feature_fn=feature_fn)) < 1e-4
    feats = np.concatenate([feature_fn(v) for v in real])
    np.testing.assert_allclose(fvd.fvd_from_features(feats, feats + 0.1),
                               jax_fvd.fvd_from_features(feats, feats + 0.1), rtol=1e-4)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        i3d.make_i3d_feature_fn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fvd.compute_fvd([], [])


def test_no_jax_in_the_video_modules():
    for mod in (port_video, i3d, fvd):
        src = open(mod.__file__).read()
        assert "import jax" not in src and "vqvae_from_gaussian_vae_tpu." not in src
    assert os.path.basename(port_video.__file__) == "video.py"
