"""The port's reconstruction metrics against the JAX package's, on the same
numpy inputs: PSNR, SSIM and MS-SSIM (NaN below 256 pixels a side), the
AlexNet LPIPS distance, InceptionV3's 2048-d pool features of (2, 64, 64,
3) images resized to 299, FID and IS.  The metric nets are seeded port
modules; the JAX nets load their ``state_dict`` (``torch.save``) through
the JAX package's own loaders, ``LPIPSMetric.load_weights`` and
``load_inception_weights``.  Bars: 1e-5 relative on the scalar metrics,
1e-4 relative L2 on the features.  Also the port's loaders: the
``lpips`` package's and torchvision's key names, and pytorch-fid's extra
entries (``fc``, ``AuxLogits``, ``num_batches_tracked``), load with
``strict=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.evaluations import fid as jax_fid
from vqvae_from_gaussian_vae_tpu.evaluations import inception_score as jax_is
from vqvae_from_gaussian_vae_tpu.evaluations.inception import InceptionV3 as JaxInception
from vqvae_from_gaussian_vae_tpu.evaluations.inception import load_inception_weights
from vqvae_from_gaussian_vae_tpu.evaluations.lpips_metric import LPIPSMetric as JaxLPIPS
from vqvae_from_gaussian_vae_tpu.evaluations.psnr import get_psnr as jax_psnr
from vqvae_from_gaussian_vae_tpu.evaluations.ssim import get_ssim_and_msssim as jax_ssim
from vqvae_from_gaussian_vae_tpu_torch.evaluations import fid, inception, inception_score
from vqvae_from_gaussian_vae_tpu_torch.evaluations.lpips_metric import (
    LPIPSAlex, LPIPSMetric, seed_weights)
from vqvae_from_gaussian_vae_tpu_torch.evaluations.psnr import get_psnr
from vqvae_from_gaussian_vae_tpu_torch.evaluations.ssim import get_ssim_and_msssim

SCALAR_RTOL = 1e-5
FEATURE_REL_L2 = 1e-4


def _pair(size, seed=0, n=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("zero_mean", [True, False])
def test_psnr_matches_jax(zero_mean):
    x, y = _pair(64)
    if not zero_mean:
        x, y = (x + 1) / 2, (y + 1) / 2
    got = get_psnr(torch.from_numpy(x), torch.from_numpy(y), zero_mean=zero_mean).numpy()
    want = np.asarray(jax_psnr(jnp.asarray(x), jnp.asarray(y), zero_mean=zero_mean))
    np.testing.assert_allclose(got, want, rtol=SCALAR_RTOL)


@pytest.mark.parametrize("size", [64, 256])
def test_ssim_and_msssim_match_jax(size):
    x, y = _pair(size, seed=size)
    s, ms = get_ssim_and_msssim(torch.from_numpy(x), torch.from_numpy(y), zero_mean=True)
    js, jms = jax_ssim(jnp.asarray(x), jnp.asarray(y), zero_mean=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=SCALAR_RTOL)
    if size < 256:  # the gate: MS-SSIM needs 256 pixels a side
        assert np.isnan(ms.numpy()).all() and np.isnan(np.asarray(jms)).all()
    else:
        assert np.isfinite(ms.numpy()).all()
        np.testing.assert_allclose(ms.numpy(), np.asarray(jms), rtol=SCALAR_RTOL)


@pytest.fixture(scope="module")
def lpips_file(tmp_path_factory):
    net = LPIPSAlex()
    seed_weights(net, 3)
    with torch.no_grad():  # positive heads, as trained ones are
        for k in range(5):
            getattr(net, f"lin{k}").model[1].weight.abs_()
    path = tmp_path_factory.mktemp("lpips") / "alex.pth"
    torch.save(net.state_dict(), path)
    return path


def test_lpips_alex_matches_jax(lpips_file):
    x, y = _pair(64, seed=1)
    got = LPIPSMetric("alex", weights_path=str(lpips_file))(
        torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(JaxLPIPS("alex", weights_path=str(lpips_file))(
        jnp.asarray(x), jnp.asarray(y)))
    assert (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=SCALAR_RTOL)


def test_lpips_loader_reads_the_lpips_and_torchvision_names(lpips_file, tmp_path):
    sd = torch.load(lpips_file, weights_only=True)
    renamed = {}
    for k, v in sd.items():  # torchvision's trunk and classifier, the lpips package's heads
        renamed[k.replace("net.features.", "features.")] = v
    renamed["classifier.1.weight"] = torch.zeros(4, 4)
    renamed["scaling_layer.shift"] = torch.zeros(1, 3, 1, 1)
    torch.save(renamed, tmp_path / "renamed.pth")
    a = LPIPSMetric("alex", weights_path=str(lpips_file)).module.state_dict()
    b = LPIPSMetric("alex", weights_path=str(tmp_path / "renamed.pth")).module.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    torch.save({k: v for k, v in sd.items() if not k.startswith("lin0")}, tmp_path / "cut.pth")
    with pytest.raises(RuntimeError, match="lin0"):
        LPIPSMetric("alex", weights_path=str(tmp_path / "cut.pth"))
    with pytest.raises(NotImplementedError):
        LPIPSMetric("vgg")


@pytest.fixture(scope="module")
def inception_file(tmp_path_factory):
    net = inception.InceptionV3(output_blocks=(3,), resize_input=True, normalize_input=False)
    inception.seed_weights(net, 5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():  # BatchNorm statistics and affine away from identity
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pth"
    torch.save(net.state_dict(), path)
    return path


def test_inception_features_match_jax(inception_file):
    x, _ = _pair(64, seed=2)
    net = inception.InceptionV3(output_blocks=(3,), resize_input=True, normalize_input=False)
    inception.load_inception_weights(net, str(inception_file))
    with torch.no_grad():
        (got,) = net(torch.from_numpy(x))
    jnet = JaxInception(output_blocks=(3,), resize_input=True, normalize_input=False)
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda v: jnet.init(jax.random.PRNGKey(0), v), jnp.zeros((1, 64, 64, 3))))
    variables, missing, unexpected = load_inception_weights(template, str(inception_file))
    assert not missing and not unexpected
    (want,) = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (2, 1, 1, 2048)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) <= FEATURE_REL_L2


def test_inception_loader_drops_pytorch_fid_extras(inception_file, tmp_path):
    sd = torch.load(inception_file, weights_only=True)
    extra = dict(sd, **{"fc.weight": torch.zeros(2, 2), "fc.bias": torch.zeros(2),
                        "AuxLogits.conv0.conv.weight": torch.zeros(1),
                        "Mixed_5b.branch1x1.bn.num_batches_tracked": torch.tensor(0)})
    torch.save(extra, tmp_path / "fid.pth")
    net = inception.InceptionV3()
    inception.load_inception_weights(net, str(tmp_path / "fid.pth"))
    assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())
    torch.save({k: v for k, v in sd.items() if "Mixed_7c" not in k}, tmp_path / "cut.pth")
    with pytest.raises(RuntimeError, match="Mixed_7c"):
        inception.load_inception_weights(net, str(tmp_path / "cut.pth"))


def test_fid_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((300, 64))
    b = 0.8 * rng.standard_normal((300, 64)) + 0.1
    got = fid.fid_from_features(a, b)
    want = jax_fid.fid_from_features(a, b)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=SCALAR_RTOL)
    m1, s1 = fid.activation_statistics(a)
    m2, s2 = jax_fid.activation_statistics(a)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_allclose(fid.calculate_frechet_distance(m1, s1, m1, s1), 0.0, atol=1e-6)


def test_inception_scores_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((40, 10)) * 3
    np.testing.assert_allclose(inception_score.get_inception_score(logits),
                               jax_is.get_inception_score(logits), rtol=SCALAR_RTOL)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got = inception_score.inception_score(probs, splits=4)
    want = jax_is.inception_score(probs, splits=4)
    np.testing.assert_allclose(got, want, rtol=SCALAR_RTOL)
