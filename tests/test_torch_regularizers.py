"""The port's baseline regularizers against the JAX package's: VQ, FSQ,
LFQ, BSQ, GQ2, the plain Gaussian and the identity.

Each test feeds the same seeded numpy latents (and, for VQ, the same
codebook, carried by ``state_dict_from_jax``; for the Gaussian ones the same
eps, the JAX draw patched to return it) through both modules, in the train
and eval branches, and holds:

  * the indices equal (the seeds give no near-tie); where VQ's two search
    forms differ, the float64 oracle must show the two codes tie within
    NEAR_TIE (the two float32 score formulas round differently);
  * z and the losses within TOL (float32 latents) or BF16_TOL (bf16
    latents: both packages round each op's result to bf16, and one ulp of
    bf16 is 2^-8 relative);
  * ``dequant(indices)`` equal to the quantized latent;
  * VQ's gradients with respect to z and the codebook within TOL;
  * GQ2's dual update with its own ``lam_range``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.parallel.train_step import _dual_config as jax_dual_config
from vqvae_from_gaussian_vae_tpu.quantization import bsq as jbsq
from vqvae_from_gaussian_vae_tpu.quantization import fsq as jfsq
from vqvae_from_gaussian_vae_tpu.quantization import gaussian as jgq
from vqvae_from_gaussian_vae_tpu.quantization import lfq as jlfq
from vqvae_from_gaussian_vae_tpu.quantization import vq as jvq
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import (
    argmax_blocked, gq_scores_reference, vq_score_operands, vq_search_plain)
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import _dual_config
from vqvae_from_gaussian_vae_tpu_torch.quantization import bsq, fsq, gaussian as gq, lfq, vq
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

TOL = 1e-4
BF16_TOL = 1e-2   # a few bf16 ulps (2^-8 relative each), for bf16-valued results
NEAR_TIE = 1e-5   # relative float64 score gap under which two codes tie
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _latent(shape, seed, dtype="float32", scale=1.0):
    z = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    np_dt, jdt, tdt = DTYPES[dtype]
    jz = jnp.asarray(z).astype(jdt)
    return jz, torch.from_numpy(np.array(jz.astype(jnp.float32))).to(tdt)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not torch.is_tensor(x) \
        else x.detach().float().numpy()


def _close(got, want, dtype="float32", msg=""):
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=msg)


def _patch_eps(monkeypatch, eps):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, s, dtype=jnp.float32: jnp.asarray(eps.reshape(s), dtype))


# ------------------------------------------------------------------ VQ


def assert_l2_indices_match(got, want, z, codebook):
    """Equal, or a float64 L2 near-tie for every differing row."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    z, e = np.asarray(z, np.float64), np.asarray(codebook, np.float64)
    for r in np.nonzero(got != want)[0]:
        d = ((z[r] - e[[got[r], want[r]]]) ** 2).sum(axis=1)
        assert abs(d[0] - d[1]) <= NEAR_TIE * max(1.0, abs(d[1])), (r, got[r], want[r], d)


def _vq_pair(fmt, dim, cn, legacy, n=96, seed=0):
    e = np.random.default_rng(seed).uniform(-0.5, 0.5, (n, dim)).astype(np.float32)
    jmod = jvq.VQQuantizer(format=fmt, n=n, dim=dim, beta=0.25, codebook_num=cn, legacy=legacy)
    port = vq.VQQuantizer(format=fmt, n=n, dim=dim, beta=0.25, codebook_num=cn, legacy=legacy)
    params = {"embedding": jnp.asarray(e)}
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmod, params, port, e


VQ_CASES = [("bchw", (2, 4, 4, 8), 4, 2), ("blc", (2, 12, 8), 8, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fmt,shape,dim,cn", VQ_CASES)
def test_vq_matches_jax(fmt, shape, dim, cn, train, legacy, dtype):
    jmod, params, port, _ = _vq_pair(fmt, dim, cn, legacy)
    jz_in, tz_in = _latent(shape, 1, dtype, scale=0.3)
    jz, jinfo = jmod.apply({"params": params}, jz_in, train=train)
    pz, pinfo = port(tz_in, train=train)
    assert set(pinfo) == set(jinfo)
    assert pinfo["indices"].dtype == torch.int32
    assert pinfo["indices"].shape == jinfo["indices"].shape
    # these seeds give no near-tie, so every index agrees and z is comparable
    np.testing.assert_array_equal(pinfo["indices"].numpy(), np.asarray(jinfo["indices"]))
    _close(pz, jz, "float32")  # zq is float32 in both
    _close(pinfo["codebook_loss"], jinfo["codebook_loss"], "float32", "codebook_loss")
    # dequant(indices) is the quantized latent's value
    deq = port.dequant(pinfo["indices"])
    np.testing.assert_allclose(deq.detach().numpy(), pz.detach().float().numpy(), rtol=0,
                               atol=1e-6)
    jdeq = jmod.apply({"params": params}, jinfo["indices"], method="dequant")
    np.testing.assert_array_equal(
        port.dequant(torch.from_numpy(np.array(jinfo["indices"]))).detach().numpy(),
        np.asarray(jdeq))


@pytest.mark.parametrize("legacy", [True, False])
def test_vq_gradients_match_jax(legacy):
    """d(codebook_loss + <zq, r>) / d(z, codebook): the straight-through
    path to z, the two loss terms to z and to the codebook rows."""
    fmt, shape, dim, cn = VQ_CASES[0]
    jmod, params, port, e = _vq_pair(fmt, dim, cn, legacy)
    z = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 0.3
    r = np.random.default_rng(3).standard_normal(shape).astype(np.float32)

    def jax_f(z, emb):
        zq, info = jmod.apply({"params": {"embedding": emb}}, z, train=True)
        return info["codebook_loss"] + jnp.sum(zq * r)

    jgz, jge = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(z), params["embedding"])
    tz = torch.from_numpy(z).requires_grad_()
    zq, info = port(tz, train=True)
    (info["codebook_loss"] + (zq * torch.from_numpy(r)).sum()).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgz), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.embedding.weight.grad.numpy(), np.asarray(jge),
                               rtol=TOL, atol=TOL)
    assert float(port.embedding.weight.grad.abs().sum()) > 0


@pytest.mark.parametrize("dim", [3, 4, 8, 16])
def test_vq_plain_search_matches_kernel_form(dim):
    """The JAX formula |z|^2 + |e|^2 - 2 z.e (the plain version) against
    the kernel's operands [2z, -1] @ [E; E^2], zero-padded to a K the kernel
    takes, searched by the kernel's plain version (first maximum)."""
    rng = np.random.default_rng(dim)
    z = torch.from_numpy(rng.standard_normal((200, dim)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((4096, dim)).astype(np.float32))
    a, b = vq_score_operands(z, e)
    assert a.shape[1] in (8, 16, 32) and a.shape[1] >= 2 * dim and b.shape == (a.shape[1], 4096)
    got = argmax_blocked(a, b, block_r=64, block_n=1000)
    want = vq_search_plain(z, e, block_r=64)
    assert_l2_indices_match(got.numpy(), want.numpy(), z.numpy(), e.numpy())
    dense = torch.argmin(torch.cdist(z.double(), e.double()), dim=1)
    assert_l2_indices_match(got.numpy(), dense.numpy(), z.numpy(), e.numpy())
    # the kernel form is the GQ score at std 1, beta 0: the oracle agrees
    s = gq_scores_reference(z.numpy()[:4], np.ones((4, dim), np.float32), e.numpy(), beta=0.0)
    assert_l2_indices_match(got.numpy()[:4], s.argmax(axis=1), z.numpy()[:4], e.numpy())


def test_vq_search_refuses_a_width_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="dim 17"):
        vq_score_operands(torch.zeros(2, 17), torch.zeros(8, 17))


# ------------------------------------------------------------------ FSQ


FSQ_LEVELS = [8, 8, 8, 5, 5, 5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fmt,shape", [("bchw", (2, 4, 4, 6)), ("blc", (2, 10, 6))])
def test_fsq_matches_jax(fmt, shape, train, dtype):
    jmod = jfsq.FSQQuantizer(levels=FSQ_LEVELS, format=fmt)
    port = fsq.FSQQuantizer(levels=FSQ_LEVELS, format=fmt)
    jz_in, tz_in = _latent(shape, 4, dtype, scale=1.5)
    jz, jinfo = jmod.apply({}, jz_in, train=train)
    pz, pinfo = port(tz_in, train=train)
    assert set(pinfo) == set(jinfo) and pz.dtype == torch.float32
    np.testing.assert_array_equal(pinfo["indices"].numpy(), np.asarray(jinfo["indices"]))
    _close(pz, jz)
    assert float(pinfo["bits"]) == float(jinfo["bits"])
    np.testing.assert_array_equal(port.dequant(pinfo["indices"]).numpy(), pz.numpy())
    np.testing.assert_allclose(
        port.dequant(pinfo["indices"]).numpy(),
        np.asarray(jmod.apply({}, jinfo["indices"], method="dequant")), rtol=0, atol=1e-7)


def test_fsq_straight_through_gradient_matches_jax():
    jmod = jfsq.FSQQuantizer(levels=FSQ_LEVELS, format="bchw")
    port = fsq.FSQQuantizer(levels=FSQ_LEVELS, format="bchw")
    z = np.random.default_rng(5).standard_normal((2, 3, 3, 6)).astype(np.float32)
    r = np.random.default_rng(6).standard_normal(z.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jmod.apply({}, v)[0] * r))(jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_()
    (port(tz)[0] * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)


def test_fsq_generate_draws_codes_from_the_generator():
    port = fsq.FSQQuantizer(levels=FSQ_LEVELS, format="bchw")
    a = port.generate(torch.Generator().manual_seed(3), (2, 4, 4, 6))
    b = port.generate(torch.Generator().manual_seed(3), (2, 4, 4, 6))
    assert a.shape == (2, 4, 4, 6) and torch.equal(a, b)
    half = torch.tensor([v // 2 for v in FSQ_LEVELS], dtype=torch.float32)
    digits = a * half + half  # each channel's level, an integer in [0, L)
    assert torch.equal(digits, digits.round())
    assert bool((digits >= 0).all()) and bool((digits < torch.tensor(FSQ_LEVELS)).all())


# ------------------------------------------------------------------ LFQ / BSQ


LFQ_INFO = ("entropy_aux_loss", "per_sample_entropy", "codebook_entropy", "commit_loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fmt,shape,size,ncb", [("bchw", (2, 3, 4, 8), 16, 2),
                                                ("blc", (2, 10, 6), 8, 2)])
def test_lfq_matches_jax(fmt, shape, size, ncb, train, dtype):
    jmod = jlfq.LFQQuantizer(format=fmt, codebook_size=size, num_codebooks=ncb)
    port = lfq.LFQQuantizer(format=fmt, codebook_size=size, num_codebooks=ncb)
    jz_in, tz_in = _latent(shape, 7, dtype)
    jz, jinfo = jmod.apply({}, jz_in, train=train)
    pz, pinfo = port(tz_in, train=train)
    assert set(pinfo) == set(jinfo) and pz.dtype == tz_in.dtype
    np.testing.assert_array_equal(pinfo["indices"].numpy(), np.asarray(jinfo["indices"]))
    _close(pz, jz, dtype)
    for k in LFQ_INFO:  # float32 entropies; the commit loss in z's dtype
        _close(pinfo[k], jinfo[k], "float32" if k != "commit_loss" else dtype, k)
    if train:
        assert float(pinfo["entropy_aux_loss"]) != 0.0
    signs = torch.where(tz_in > 0, 1.0, -1.0)
    np.testing.assert_array_equal(port.dequant(pinfo["indices"]).numpy(), signs.numpy())
    np.testing.assert_array_equal(port.dequant(pinfo["indices"]).numpy(),
                                  np.asarray(jmod.apply({}, jinfo["indices"], method="dequant")))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fmt,shape,size,ncb", [("bchw", (2, 3, 4, 16), 2, 16),
                                                ("blc", (2, 10, 8), 4, 4)])
def test_bsq_matches_jax(fmt, shape, size, ncb, train, dtype):
    jmod = jbsq.BSQQuantizer(format=fmt, codebook_size=size, num_codebooks=ncb)
    port = bsq.BSQQuantizer(format=fmt, codebook_size=size, num_codebooks=ncb)
    jz_in, tz_in = _latent(shape, 8, dtype)
    jz, jinfo = jmod.apply({}, jz_in, train=train)
    pz, pinfo = port(tz_in, train=train)
    assert set(pinfo) == set(jinfo) and pz.dtype == tz_in.dtype
    np.testing.assert_array_equal(pinfo["indices"].numpy(), np.asarray(jinfo["indices"]))
    _close(pz, jz, dtype)
    for k in LFQ_INFO[:3]:
        _close(pinfo[k], jinfo[k], dtype, k)
    if train:
        assert float(pinfo["entropy_aux_loss"]) != 0.0
    q = torch.where(tz_in > 0, 1.0, -1.0) * (1.0 / port.embed_dim ** 0.5)
    np.testing.assert_allclose(port.dequant(pinfo["indices"]).numpy(), q.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(port.dequant(pinfo["indices"]).numpy(),
                                  np.asarray(jmod.apply({}, jinfo["indices"], method="dequant")))


@pytest.mark.parametrize("kind", ["lfq", "bsq"])
def test_entropy_losses_are_differentiable_like_jax(kind):
    shape = (2, 6, 8)
    z = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    jcls, pcls = {"lfq": (jlfq.LFQQuantizer, lfq.LFQQuantizer),
                  "bsq": (jbsq.BSQQuantizer, bsq.BSQQuantizer)}[kind]
    jmod, port = jcls(format="blc", codebook_size=16, num_codebooks=2), \
        pcls(format="blc", codebook_size=16, num_codebooks=2)

    def jax_f(v):
        zq, info = jmod.apply({}, v, train=True)
        extra = info.get("commit_loss", 0.0)
        return info["entropy_aux_loss"] + extra + jnp.sum(zq * 0.1)

    jg = jax.grad(jax_f)(jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_()
    zq, info = port(tz, train=True)
    (info["entropy_aux_loss"] + info.get("commit_loss", 0.0) + (zq * 0.1).sum()).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ Gaussian / Identity


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fmt,shape", [("bchw", (2, 4, 4, 8)), ("blc", (2, 6, 8))])
def test_gaussian_matches_jax(fmt, shape, train, monkeypatch):
    z = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    eps = np.random.default_rng(11).standard_normal(shape[:-1] + (shape[-1] // 2,)) \
        .astype(np.float32)
    _patch_eps(monkeypatch, eps)
    jmod = jgq.GaussianRegularizer(format=fmt)
    jz, jinfo = jmod.apply({}, jnp.asarray(z), train=train, rngs={"sample": jax.random.PRNGKey(0)})
    port = gq.GaussianRegularizer(format=fmt)
    pz, pinfo = port(torch.from_numpy(z), train=train, eps=torch.from_numpy(eps))
    assert set(pinfo) == set(jinfo)
    _close(pz, jz)
    for k in jinfo:
        _close(pinfo[k], jinfo[k], msg=k)
    with pytest.raises(NotImplementedError):
        port.dequant(torch.zeros(2, 4, 4, 1, dtype=torch.int32))
    # eps from a generator: the same draw for the same seed
    a, _ = port(torch.from_numpy(z), generator=torch.Generator().manual_seed(1))
    b, _ = port(torch.from_numpy(z), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_identity_matches_jax():
    z = np.random.default_rng(12).standard_normal((2, 3, 3, 4)).astype(np.float32)
    jz, jinfo = jgq.IdentityRegularizer().apply({}, jnp.asarray(z), train=True)
    pz, pinfo = gq.IdentityRegularizer()(torch.from_numpy(z), train=True)
    assert pinfo == jinfo == {}
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))
    idx = torch.arange(6).reshape(2, 3)
    assert gq.IdentityRegularizer().dequant(idx) is idx


# ------------------------------------------------------------------ GQ2


def _gq2_latent(shape, seed):
    """mu, logvar spread so the per-sub-codebook KL falls in all three
    bands around log2(256) = 8 +- 0.5 bits."""
    rng = np.random.default_rng(seed)
    half = shape[-1] // 2
    mu = rng.standard_normal(shape[:-1] + (half,)) * rng.uniform(0.3, 2.5, shape[:-1] + (1,))
    logvar = rng.uniform(-4.0, 1.0, shape[:-1] + (half,))
    return np.concatenate([mu, logvar], axis=-1).astype(np.float32)


@pytest.mark.parametrize("use_ste", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_gq2_matches_jax(train, use_ste, monkeypatch):
    shape = (2, 3, 4, 16)  # 2 sub-codebooks of dim 4 in each half
    z = _gq2_latent(shape, 13)
    eps = np.random.default_rng(14).standard_normal(shape[:-1] + (8,)).astype(np.float32)
    _patch_eps(monkeypatch, eps)
    duals_np = {"lam": 1.3, "lam_min": 0.5, "lam_max": 2.0}
    kw = dict(dim=4, codebook_size=256, seed=7, use_ste=use_ste, backend="xla")
    jmod = jgq.GaussianQuantRegularizer2(**kw)
    jz, jinfo = jmod.apply({}, jnp.asarray(z), train=train,
                           duals={k: jnp.float32(v) for k, v in duals_np.items()},
                           rngs={"sample": jax.random.PRNGKey(0)})
    port = gq.GaussianQuantRegularizer2(**kw)
    pz, pinfo = port(torch.from_numpy(z), train=train,
                     duals={k: torch.tensor(v) for k, v in duals_np.items()},
                     eps=torch.from_numpy(eps))
    assert set(pinfo) == set(jinfo)
    cb = port.codebook.numpy()
    np.testing.assert_array_equal(cb, np.asarray(jmod.apply({}, method="codebook_array")))
    got, want = pinfo["indices"].numpy(), np.asarray(jinfo["indices"])
    assert got.shape == want.shape == (2, 3, 4, 2) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)  # these seeds give no near-tie
    _close(pz, jz)
    _close(pinfo["zhat_quant"], jinfo["zhat_quant"])
    for k in ("kl_loss", "bits-mean", "bits-min", "bits-max", "lam", "lam-min", "lam-max",
              "mu", "std", "zhat_noquant"):
        _close(pinfo[k], jinfo[k], msg=k)
    assert float(pinfo["bits-min"]) < 7.5 and float(pinfo["bits-max"]) > 8.5
    np.testing.assert_array_equal(port.dequant(pinfo["indices"]).numpy(),
                                  pinfo["zhat_quant"].numpy())
    np.testing.assert_array_equal(port.dequant(pinfo["indices"]).numpy(),
                                  np.asarray(jmod.apply({}, jinfo["indices"], method="dequant")))


def test_gq2_straight_through_gradient_reaches_the_posterior():
    """With use_ste the output's value is the code and its gradient the
    Gaussian sample's: d(sum(zhat * r)) / d mu = r, / d logvar = r eps std / 2."""
    z = torch.from_numpy(_gq2_latent((1, 2, 2, 8), 15)).requires_grad_()
    eps = torch.from_numpy(np.random.default_rng(16).standard_normal((1, 2, 2, 4))
                           .astype(np.float32))
    port = gq.GaussianQuantRegularizer2(dim=4, codebook_size=256, seed=7)
    zhat, info = port(z, train=True, eps=eps)
    assert torch.equal(zhat.detach(), info["zhat_quant"])
    r = torch.randn(zhat.shape, generator=torch.Generator().manual_seed(0))
    (zhat * r).sum().backward()
    np.testing.assert_allclose(z.grad[..., :4].numpy(), r.numpy(), rtol=1e-6)
    std = torch.exp(0.5 * z.detach()[..., 4:])
    np.testing.assert_allclose(z.grad[..., 4:].numpy(), (r * eps * std / 2).numpy(), rtol=1e-5)


@pytest.mark.parametrize("stats", [
    {"bits-mean": 8.2, "bits-min": 7.2, "bits-max": 9.1},
    {"bits-mean": 7.9, "bits-min": 7.6, "bits-max": 8.4},
    {"bits-mean": 16.0, "bits-min": 0.1, "bits-max": 40.0},
])
@pytest.mark.parametrize("duals", [
    {"lam": 1.0, "lam_min": 1.0, "lam_max": 1.0},
    {"lam": 3.0, "lam_min": 1.000005e-7, "lam_max": 9.99999e6},  # next to (1e-7, 1e7)
])
def test_gq2_dual_update_with_its_lam_range(stats, duals):
    kw = dict(dim=4, codebook_size=256, tolerance=0.5, lam_factor=1.01)
    cfg = _dual_config(gq.GaussianQuantRegularizer2(**kw))
    assert cfg == jax_dual_config(jgq.GaussianQuantRegularizer2(**kw))
    assert cfg == (8, 0.5, 1.01, (1e-7, 1e7))
    log_n, tol, factor, lam_range = cfg
    want = jgq.GaussianQuantRegularizer2.update_duals(
        {k: jnp.float32(v) for k, v in duals.items()},
        {k: jnp.float32(v) for k, v in stats.items()}, log_n, tol, factor, lam_range)
    got = gq.update_duals(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in duals.items()},
        {k: torch.tensor(v, dtype=torch.float32) for k, v in stats.items()},
        log_n, tol, factor, lam_range)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
