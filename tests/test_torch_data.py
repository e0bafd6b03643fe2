"""The port's data modules against the JAX package's, on files written
under a temporary folder: ``load_image``, ``SimpleDataset`` (a folder and a
.txt list), ``_PrefetchLoader`` (two epochs, the train shuffle, shards),
``ImageDataModuleFromConfig`` on the Python loader and on the native one
(where its library builds here), each batch byte for byte; the MNIST idx
and CIFAR-10 batch readers; and the registry, through which the ``data:``
section of every shipped config instantiates."""

import glob
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.data import dataset as jds
from vqvae_from_gaussian_vae_tpu.data import native_loader as jnative
from vqvae_from_gaussian_vae_tpu.data import toy as jtoy
from vqvae_from_gaussian_vae_tpu_torch.data import dataset as pds
from vqvae_from_gaussian_vae_tpu_torch.data import native_loader as pnative
from vqvae_from_gaussian_vae_tpu_torch.data import toy as ptoy
from vqvae_from_gaussian_vae_tpu_torch.utils.config import instantiate_from_config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "vqvae_from_gaussian_vae_tpu"


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """22 images of several sizes, JPEG, jpg and png, some in a subfolder."""
    root = tmp_path_factory.mktemp("imgs")
    (root / "sub").mkdir()
    rng = np.random.default_rng(0)
    for i in range(22):
        arr = rng.integers(0, 255, (36 + 3 * i, 48 - i, 3), dtype=np.uint8)
        ext = ("JPEG", "jpg", "png")[i % 3]
        folder = root / "sub" if i % 4 == 0 else root
        Image.fromarray(arr).save(folder / f"img_{i:02d}.{ext}",
                                  **({"quality": 90} if ext != "png" else {}))
    return str(root)


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["fpath"] == y["fpath"]
        assert x["img"].dtype == y["img"].dtype == np.float32
        assert np.array_equal(x["img"], y["img"])


def _same_epoch(a, b, n_files):
    """The native pool fills each batch with the files its threads finish
    first: the same batch sizes, no file twice, the same image for a file
    in both epochs, and every file in both where no batch was dropped."""
    assert sorted(len(x["fpath"]) for x in a) == sorted(len(y["fpath"]) for y in b)
    imgs = [{p: x["img"][i] for x in batches for i, p in enumerate(x["fpath"])}
            for batches in (a, b)]
    assert len(imgs[0]) == len(imgs[1]) == sum(len(x["fpath"]) for x in a)
    if len(imgs[0]) == n_files:
        assert imgs[0].keys() == imgs[1].keys()
    common = imgs[0].keys() & imgs[1].keys()
    assert common
    for p in common:
        assert np.array_equal(imgs[0][p], imgs[1][p])


@pytest.mark.parametrize("size", [16, 32])
def test_load_image_matches_jax(image_root, size):
    for p in sorted(glob.glob(image_root + "/**/*.*", recursive=True))[:6]:
        want = jds.load_image(p, size)
        got = pds.load_image(p, size)
        assert got.shape == (size, size, 3) and np.array_equal(got, want)


def test_simple_dataset_folder_and_list_match_jax(image_root, tmp_path):
    jset, pset = jds.SimpleDataset(image_root, 24), pds.SimpleDataset(image_root, 24)
    assert pset.fpaths == jset.fpaths and len(pset) == 22
    item = pset[3]
    assert item["fpath"] == jset[3]["fpath"] and np.array_equal(item["img"], jset[3]["img"])
    listing = tmp_path / "files.txt"
    listing.write_text("\n".join(reversed(jset.fpaths)) + "\n")
    assert pds.SimpleDataset(str(listing), 24).fpaths == jds.SimpleDataset(str(listing), 24).fpaths
    with pytest.raises(AssertionError):  # the JAX module asserts; the port raises ValueError
        jds.SimpleDataset(str(tmp_path / "empty"), 24)
    with pytest.raises(ValueError, match="empty"):
        pds.SimpleDataset(str(tmp_path / "empty"), 24)


@pytest.mark.parametrize("shuffle,drop_last,shard", [(True, True, (0, 1)), (False, False, (1, 3)),
                                                     (True, False, (0, 2))])
def test_prefetch_loader_matches_jax_over_two_epochs(image_root, shuffle, drop_last, shard):
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=3, prefetch=2, drop_last=drop_last,
              seed=5, shard_id=shard[0], num_shards=shard[1])
    jl = jds._PrefetchLoader(jds.SimpleDataset(image_root, 16), **kw)
    pl = pds._PrefetchLoader(pds.SimpleDataset(image_root, 16), **kw)
    assert len(pl) == len(jl)
    for _ in range(2):  # the shuffle is default_rng(seed + epoch)
        _equal_batches(list(pl), list(jl))


def test_prefetch_loader_raises_a_decode_error_and_stops_its_thread(image_root, tmp_path):
    """A file that does not decode raises in the consumer (the JAX loader's
    thread would end the epoch early), and a consumer that stops after one
    batch leaves no decoding thread behind."""
    import threading

    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    ds = pds.SimpleDataset(image_root, 16)
    ds.fpaths = ds.fpaths[:3] + [str(bad)] + ds.fpaths[3:]
    loader = pds._PrefetchLoader(ds, batch_size=2, num_workers=2, prefetch=1)
    with pytest.raises(Exception, match="bad.png|identify"):
        list(loader)
    before = threading.active_count()
    it = iter(pds._PrefetchLoader(pds.SimpleDataset(image_root, 16), batch_size=2,
                                  num_workers=2, prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() == before


def _module_cfg(pkg, root, use_native):
    ds = {"target": f"{pkg}.data.dataset.SimpleDataset", "params": {"root": root,
                                                                     "image_size": 16}}
    return {"batch_size": 5, "train": ds, "validation": ds, "num_workers": 2, "seed": 3,
            "use_native": use_native}


@pytest.mark.parametrize("use_native", [False, True])
def test_image_data_module_matches_jax(image_root, use_native):
    if use_native and not (jnative.native_available() and pnative.native_available()):
        pytest.skip("native loader not built")
    jm = jds.ImageDataModuleFromConfig(**_module_cfg(PKG, image_root, use_native))
    pm = pds.ImageDataModuleFromConfig(**_module_cfg(PKG, image_root, use_native))
    for split in ("train", "validation"):
        jl = getattr(jm, {"train": "train_dataloader", "validation": "val_dataloader"}[split])()
        pl = getattr(pm, {"train": "train_dataloader", "validation": "val_dataloader"}[split])()
        assert pm.loader_kind == ("native" if use_native else "python")
        assert type(pl).__name__ == type(jl).__name__
        assert len(pl) == len(jl) == (4 if split == "train" else 5)  # drop_last: train only
        for _ in range(2):
            if use_native:  # the C++ pool hands batches over as its threads finish them
                _same_epoch(list(pl), list(jl), 22)
            else:
                _equal_batches(list(pl), list(jl))


def test_native_decode_matches_jax(image_root):
    if not (jnative.native_available() and pnative.native_available()):
        pytest.skip("native loader not built")
    for p in sorted(glob.glob(image_root + "/*.*"))[:4]:
        assert np.array_equal(pnative.decode_image(p, 24), jnative.decode_image(p, 24))


def test_toy_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    digits = rng.integers(0, 255, (5, 28, 28), dtype=np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">III", 5, 28, 28) + digits.tobytes())
    cifar = tmp_path / "cifar-10-batches-py"
    cifar.mkdir()
    data = rng.integers(0, 255, (4, 3 * 32 * 32), dtype=np.uint8)
    with open(cifar / "test_batch", "wb") as f:
        pickle.dump({b"data": data, b"labels": [0, 1, 2, 3]}, f)
    for size in (28, 32, 64):
        for jcls, pcls in ((jtoy.MNISTDataset, ptoy.MNISTDataset),
                           (jtoy.CIFAR10Dataset, ptoy.CIFAR10Dataset)):
            jset = jcls(str(tmp_path), image_size=size, split="test")
            pset = pcls(str(tmp_path), image_size=size, split="test")
            assert len(pset) == len(jset)
            for i in range(len(pset)):
                got, want = pset[i], jset[i]
                assert got["fpath"] == want["fpath"] and np.array_equal(got["img"], want["img"])
    with pytest.raises(FileNotFoundError):
        ptoy.MNISTDataset(str(tmp_path), split="train")


def test_every_shipped_data_section_instantiates(image_root):
    """Each config's ``data:`` (its root pointed at the temporary folder)
    builds the port's data module, in the JAX and the pit spellings, and its
    train loader yields a batch of the config's shape."""
    configs = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(configs) >= 15
    for path in configs:
        cfg = load_config(path, dotlist=[f"data.params.train.params.root={image_root}",
                                         "data.params.train.params.image_size=16",
                                         "data.params.batch_size=4", "data.params.num_workers=2"])
        mod = instantiate_from_config(cfg["data"])
        assert isinstance(mod, pds.ImageDataModuleFromConfig), path
        batch = next(iter(mod.train_dataloader()))
        assert batch["img"].shape == (4, 16, 16, 3) and len(batch["fpath"]) == 4
    pit = {"target": "pit.data.ImageDataModuleFromConfig",
           "params": {"batch_size": 2, "train": {"target": "pit.data.SimpleDataset",
                                                 "params": {"root": image_root,
                                                            "image_size": 8}}}}
    assert isinstance(instantiate_from_config(pit), pds.ImageDataModuleFromConfig)
    for target in (f"{PKG}.data.dataset.StableDataModuleFromConfig",
                   "pit.dataset.dataset.StableDataModuleFromConfig"):
        with pytest.raises(NotImplementedError, match="sdata"):
            instantiate_from_config({"target": target, "params": {}})
    from vqvae_from_gaussian_vae_tpu_torch.data import video as pvideo

    stills = instantiate_from_config({"target": f"{PKG}.data.video.ImageDataset",
                                      "params": {"root": image_root, "image_size": 8,
                                                 "num_frames": 3}})
    assert isinstance(stills, pvideo.ImageDataset) and stills[0]["video"].shape == (3, 8, 8, 3)
    with pytest.raises(ValueError, match="Clip list is empty"):  # an image folder holds no clip
        instantiate_from_config({"target": f"{PKG}.data.video.VideoDataset",
                                 "params": {"root": image_root, "image_size": 8}})
