"""Gradient accumulation and remat (activation checkpointing) in the port,
against the JAX package: ``make_optimizers(..., accumulate_grad_batches=2)``
against optax.MultiSteps on the vector of ``tests/test_remat_accum.py``,
and the UNet encoder of that test and a 2-layer ViT with ``remat=True``
against their plain forms and against the JAX remat encoders."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models.unet import Encoder as JaxEncoder
from vqvae_from_gaussian_vae_tpu.models.vit import TransformerEncoder as JaxTransformerEncoder
from vqvae_from_gaussian_vae_tpu.parallel.train_state import make_optimizers as jax_make_optimizers
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import init_weights
from vqvae_from_gaussian_vae_tpu_torch.models.unet import Encoder
from vqvae_from_gaussian_vae_tpu_torch.models.vit import TransformerEncoder
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import MultiSteps, make_optimizers
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

UNET = dict(attn_type="vanilla", double_z=True, z_channels=4, resolution=32, in_channels=3,
            out_ch=3, ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16],
            dropout=0.0)  # tests/test_remat_accum.py's encoder
VIT = dict(image_size=32, patch_size=8, width=128, layers=2, heads=2, mlp_ratio=4,
           double_z=True, z_channels=4)


def test_accumulation_matches_optax_multisteps():
    """k = 2 on the vector of tests/test_remat_accum.py: four updates, the
    parameters after each within 1e-6 of MultiSteps's; Adam's count moves
    on every second step; the accumulator survives a state_dict round trip."""
    jopt, _ = jax_make_optimizers(1e-2, accumulate_grad_batches=2)
    ae, _ = make_optimizers(1e-2, accumulate_grad_batches=2)
    xs = [np.array(v, np.float32) for v in
          ([1.0, 2.0, 3.0], [2.0, 0.5, 1.0], [0.5, -1.0, 2.0], [3.0, 1.0, -0.5])]
    wj = jnp.ones((3,))
    sj = jopt.init(wj)
    p = torch.nn.Parameter(torch.ones(3))
    opt = ae.build([("w", p)])
    assert isinstance(opt, MultiSteps)
    for i, x in enumerate(xs):
        gj = jax.grad(lambda w: jnp.sum((w * x) ** 2))(wj)
        u, sj = jopt.update(gj, sj, wj)
        wj = optax.apply_updates(wj, u)
        p.grad = torch.autograd.grad(torch.sum((p * torch.from_numpy(x)) ** 2), p)[0]
        opt.step()
        p.grad = None
        if i == 0:  # a mid step: an optimizer rebuilt from its state_dict goes on alike
            moved = ae.build([("w", p)])
            moved.load_state_dict(opt.state_dict())
            opt = moved
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(wj), rtol=1e-6, atol=1e-7)
        assert int(opt.inner.state[p]["step"]) == (i + 1) // 2 if i else not opt.inner.state


def _jax_params(module, sd, example):
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda e: module.init(jax.random.PRNGKey(0), e)["params"], example))
    params, _, _ = convert_state_dict(sd, template, strict=True)
    return params


def _out_and_grads(module, x):
    x = x.clone().requires_grad_()
    out = module(x, train=True)
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(torch.sum(out.float() ** 2), [p for _, p in
                                                              module.named_parameters()])
    return out.detach(), dict(zip(names, grads))


def _jax_remat_out_and_grads(jmodule, plain, x):
    """The JAX remat module's output and its gradients of sum(out**2), on
    ``plain``'s weights, as numpy (the gradients under the port's names)."""
    jx = jnp.asarray(x.numpy())
    params = _jax_params(jmodule, {k: v.detach() for k, v in plain.state_dict().items()}, jx)

    @jax.jit
    def out_and_grad(p):
        fwd = lambda p: jmodule.apply({"params": p}, jx, train=True)  # noqa: E731
        return fwd(p), jax.grad(lambda p: jnp.sum(fwd(p).astype(jnp.float32) ** 2))(p)

    jout, jgrad = out_and_grad(params)
    return (np.asarray(jout.astype(jnp.float32)),
            {k: v.float().numpy() for k, v in state_dict_from_jax(jgrad).items()})


def _assert_grads_close(got, want, rel):
    """Each gradient within ``rel`` of its norm.  A gradient that is zero in
    exact arithmetic (under 1e-7 of the whole) must stay as small."""
    whole = np.linalg.norm(np.concatenate([w.ravel() for w in want.values()]))
    for k, g in got.items():
        g, w = g.float().numpy(), want[k]
        if np.linalg.norm(w) < 1e-7 * whole:
            assert np.linalg.norm(g) < 1e-7 * whole, k
        else:
            assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w), k


def test_unet_remat_matches_plain_and_the_jax_remat_encoder():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    plain, remat = Encoder(**UNET), Encoder(**UNET, remat=True)
    init_weights(plain, seed=0)
    remat.load_state_dict(plain.state_dict())
    out_p, g_p = _out_and_grads(plain, x)
    out_r, g_r = _out_and_grads(remat, x)
    assert torch.equal(out_p, out_r)
    for k in g_p:
        torch.testing.assert_close(g_r[k], g_p[k], rtol=1e-6, atol=1e-7)
    jout, want = _jax_remat_out_and_grads(JaxEncoder(**UNET, remat=True), plain, x)
    np.testing.assert_allclose(out_r.numpy(), jout, atol=1e-5, rtol=1e-4)
    # conv1's bias feeds a GroupNorm of one channel a group (ch 32): zero in
    # exact arithmetic, float32 noise in both packages (as
    # tests/test_torch_train_step_unet.py holds it)
    _assert_grads_close(g_r, want, 1e-4)


def test_unet_remat_bf16_recomputes_the_kernels_functions():
    """bf16: the fused resample and attention autograd Functions (their
    plain versions on the CPU) give the same gradient when recomputed."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    plain = Encoder(**UNET, dtype="bfloat16")
    remat = Encoder(**UNET, dtype="bfloat16", remat=True)
    init_weights(plain, seed=1)
    remat.load_state_dict(plain.state_dict())
    assert plain.down[0].downsample.fused
    out_p, g_p = _out_and_grads(plain, x)
    out_r, g_r = _out_and_grads(remat, x)
    assert torch.equal(out_p, out_r)
    for k in g_p:
        assert torch.equal(g_r[k], g_p[k]), k


# the JAX remat blocks bypass its streamed LN-add loop, so float32 differs
# by rounding (measured ~5e-7 relative on the output, ~1e-6 on a gradient);
# bf16 also rounds at other places (tests/test_torch_vit.py's bar, 3e-2
# relative L2; measured ~8e-3 on the output, ~1.4e-2 on a gradient)
VIT_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (3e-2, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_remat_matches_plain(dtype):
    """The remat ViT streams the same (stream, delta) steps as the plain one,
    so its output and gradients are bit-equal to it; both are held against
    the JAX remat encoder on the same weights."""
    plain = TransformerEncoder(**VIT, dtype=dtype)
    remat = TransformerEncoder(**VIT, remat=True, dtype=dtype)
    init_weights(plain, seed=2)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3))
                         .astype(np.float32))
    out_p, g_p = _out_and_grads(plain, x)
    out_r, g_r = _out_and_grads(remat, x)
    assert torch.equal(out_p, out_r)
    for k in g_p:
        assert torch.equal(g_r[k], g_p[k]), k
    jout, want = _jax_remat_out_and_grads(
        JaxTransformerEncoder(**VIT, remat=True, dtype=getattr(jnp, dtype)), plain, x)
    out_rel, grad_rel = VIT_TOL[dtype]
    got = out_r.float().numpy()
    assert np.linalg.norm(got - jout) <= out_rel * np.linalg.norm(jout)
    _assert_grads_close(g_r, want, grad_rel)
