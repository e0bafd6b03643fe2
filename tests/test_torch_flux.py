"""The port's FLUX (``models/flux.py``) against the JAX package's, and the
cross-attention gate of ``sdpa_token_major``.

``tests/test_flux.py``'s ``TINY`` configuration (hidden 64, 4 heads of 16,
2 + 2 blocks).  Random parameters on the JAX modules' ``jax.eval_shape``
trees, every layer nonzero (the JAX init zeroes the final projection, the
ControlNet's output projections and last hint conv, LoRA's ``up`` and the
IP k / v weights, which would make the velocity 0 and cut the attention
off), rounded to bf16 so that both sides hold the same values, carried into
the port by ``state_dict_from_jax`` (strict).  Both compute in bf16; at
head dim 16 both take the einsum attention (the port's plain path, JAX's
path off the TPU).  Bars: 2e-2 relative L2 for the forward, the
ControlNet's residuals and one LoRA + IP-adapter forward; the float32
helpers (RoPE, schedule, packing) 1e-6, the timestep embedding 1e-4 (cos and
sin of arguments up to 1000).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_flux import TINY as JAX_TINY
from tests.test_torch_jax_compile import light_xla_compile  # noqa: F401  (JAX side)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models import flux as jflux
from vqvae_from_gaussian_vae_tpu_torch.models import flux as pflux
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.utils.convert import state_dict_from_jax

BF16_REL_L2 = 2e-2
F32_TOL = 1e-6
TIME_TOL = 1e-4  # cos / sin of arguments up to 1000, where a float32 ulp is 6.1e-5
TINY = pflux.FluxParams(**dataclasses.asdict(JAX_TINY))
CTX = 32  # the IP-adapter's context width


def random_flux_tree(init, *args, seed=0):
    """Random bf16-valued float32 parameters on ``init``'s tree: kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
    tree = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            x = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "scale":
            x = 1 + 0.1 * rng.standard_normal(a.shape)
        else:
            x = 0.1 * rng.standard_normal(a.shape)
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def flux_inputs(b=2, seed=0):
    """img tokens for an 8x8 latent grid (16 tokens), 8 text tokens."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, 16, 64)).astype(np.float32)
    img_ids = np.asarray(jflux.make_img_ids(8, 8, b))
    txt = rng.standard_normal((b, 8, TINY.context_in_dim)).astype(np.float32)
    txt_ids = np.zeros((b, 8, 3), np.float32)
    t = np.array([0.5, 0.25][:b], np.float32)
    y = rng.standard_normal((b, TINY.vec_in_dim)).astype(np.float32)
    g = np.full((b,), 4.0, np.float32)
    return img, img_ids, txt, txt_ids, t, y, g


def port_module(cls, params, *args, **kwargs):
    module = pflux.build(cls, *args, **kwargs)
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def flux_pair():
    """(JAX Flux, its params, port Flux) with LoRA rank 4 and IP context 32:
    the plain forward leaves both unused (image_proj None; the LoRA deltas
    are part of every forward, here nonzero)."""
    jmod = jflux.Flux(JAX_TINY, lora_rank=4, remat=False, ip_context_dim=CTX)
    img, img_ids, txt, txt_ids, t, y, g = flux_inputs()
    image_proj = jnp.zeros((2, 4, CTX))
    params = random_flux_tree(jmod.init, img, img_ids, txt, txt_ids, t, y, None, g, image_proj,
                              1.0)
    return jmod, params, port_module(pflux.Flux, params, TINY, lora_rank=4,
                                     ip_context_dim=CTX)


def test_flux_forward_matches_jax(flux_pair):
    jmod, params, pmod = flux_pair
    args = flux_inputs()
    want = jax.jit(jmod.apply)({"params": params}, *args[:6], None, args[6])
    with torch.no_grad():
        got = pmod(*_t(args[:6]), None, torch.from_numpy(args[6]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 16, 64)
    assert np.abs(np.asarray(want, np.float32)).max() > 1e-2  # the velocity is not 0
    assert rel_l2(got.float(), want) <= BF16_REL_L2


def test_flux_ip_adapter_and_controlnet_residuals_match_jax(flux_pair):
    """One forward with image tokens (the IP cross-attention over 4 tokens,
    scale 0.7) and per-block ControlNet residuals."""
    jmod, params, pmod = flux_pair
    rng = np.random.default_rng(3)
    args = flux_inputs()
    image_proj = rng.standard_normal((2, 4, CTX)).astype(np.float32)
    res = [rng.standard_normal((2, 16, TINY.hidden_size)).astype(np.float32) * 0.5]
    fn = jax.jit(lambda p, r, ip: jmod.apply({"params": p}, *args[:6], r, args[6], ip, 0.7))
    want = fn(params, [jnp.asarray(res[0], jnp.bfloat16)], jnp.asarray(image_proj, jnp.bfloat16))
    with torch.no_grad():
        got = pmod(*_t(args[:6]), [torch.from_numpy(res[0]).bfloat16()],
                   torch.from_numpy(args[6]), torch.from_numpy(image_proj).bfloat16(), 0.7)
        plain = pmod(*_t(args[:6]), None, torch.from_numpy(args[6]))
    assert rel_l2(got.float(), plain.float()) > 0.05  # both paths move the velocity
    assert rel_l2(got.float(), want) <= BF16_REL_L2


def test_controlnet_matches_jax():
    jmod = jflux.ControlNetFlux(JAX_TINY, control_channels=8, controlnet_depth=2)
    img, img_ids, txt, txt_ids, t, y, g = flux_inputs(seed=4)
    cond = np.random.default_rng(5).standard_normal((2, 8, 8, 8)).astype(np.float32)
    params = random_flux_tree(jmod.init, img, img_ids, cond, txt, txt_ids, t, y, g, seed=6)
    want = jax.jit(jmod.apply)({"params": params}, img, img_ids, cond, txt, txt_ids, t, y, g)
    pmod = port_module(pflux.ControlNetFlux, params, TINY, 8, 2)
    assert [n for n, _ in pmod.input_hint_block.named_children()][::2] == \
        [str(i) for i in range(0, 15, 2)]
    with torch.no_grad():
        got = pmod(*_t((img, img_ids, cond, txt, txt_ids, t, y, g)))
    assert len(got) == len(want) == 2
    for r_got, r_want in zip(got, want):
        assert tuple(r_got.shape) == (2, 16, TINY.hidden_size)
        assert rel_l2(r_got.float(), r_want) <= BF16_REL_L2


def test_image_proj_model_matches_jax():
    jmod = jflux.ImageProjModel(cross_attention_dim=CTX, clip_embeddings_dim=24,
                                clip_extra_context_tokens=4)
    x = np.random.default_rng(7).standard_normal((2, 24)).astype(np.float32)
    params = random_flux_tree(jmod.init, x, seed=8)
    pmod = port_module(pflux.ImageProjModel, params, CTX, 24, 4)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    assert rel_l2(got.float(), jax.jit(jmod.apply)({"params": params}, x)) <= BF16_REL_L2


def test_the_zero_layers_are_the_jax_inits():
    """``init_flux_weights`` zeroes exactly the parameters the JAX init
    leaves zero (plus the biases); a freshly seeded flux's velocity is 0.
    One block of each kind: every block of a kind has the same layers."""
    one = dataclasses.replace(JAX_TINY, depth=1, depth_single_blocks=1)
    jmod = jflux.Flux(one, lora_rank=4, remat=False, ip_context_dim=CTX)
    args = flux_inputs(b=1)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), *args[:6], None, args[6],
                                jnp.zeros((1, 4, CTX)), 1.0)["params"]
    sd = state_dict_from_jax(params)
    want = {k for k, v in sd.items() if not k.endswith(".bias") and not v.any()}
    pmod = pflux.build(pflux.Flux, dataclasses.replace(TINY, depth=1, depth_single_blocks=1),
                       lora_rank=4, ip_context_dim=CTX)
    pflux.init_flux_weights(pmod, torch.Generator().manual_seed(0))
    got = {k for k, v in pmod.state_dict().items() if not k.endswith(".bias") and not v.any()}
    assert got == want and {k for k in sd if pflux.ZERO_INIT.search(k)} == want
    assert all(not v.any() for k, v in pmod.state_dict().items() if k.endswith(".bias"))
    with torch.no_grad():
        out = pmod(*_t(args[:6]), None, torch.from_numpy(args[6]))
    assert not out.any()
    cn = pflux.build(pflux.ControlNetFlux, TINY, 8, 2)
    zero = {k for k in cn.state_dict() if pflux.ZERO_INIT.search(k)}
    assert zero == {"controlnet_blocks.0.weight", "controlnet_blocks.1.weight",
                    "input_hint_block.14.weight"}


def test_float32_helpers_match_jax():
    rng = np.random.default_rng(9)
    t = rng.uniform(0, 1, (3,)).astype(np.float32)
    for dim in (256, 7):
        np.testing.assert_allclose(pflux.timestep_embedding(torch.from_numpy(t), dim).numpy(),
                                   jflux.timestep_embedding(jnp.asarray(t), dim), atol=TIME_TOL)
    ids = np.asarray(jflux.make_img_ids(8, 6, 2))
    assert np.array_equal(pflux.make_img_ids(8, 6, 2).numpy(), ids)
    pe_p = pflux.embed_nd(torch.from_numpy(ids), (4, 6, 6), 10000)
    pe_j = jflux.embed_nd(jnp.asarray(ids), (4, 6, 6), 10000)
    for a, b in zip(pe_p, pe_j):
        np.testing.assert_allclose(a.numpy(), b, atol=F32_TOL)
    q = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    for a, b in zip(pflux.apply_rope(torch.from_numpy(q), torch.from_numpy(k), pe_p),
                    jflux.apply_rope(jnp.asarray(q), jnp.asarray(k), pe_j)):
        np.testing.assert_allclose(a.numpy(), b, atol=F32_TOL)
    for steps, seq in ((25, 256), (4, 4096), (2, 4)):
        assert pflux.get_schedule(steps, seq) == jflux.get_schedule(steps, seq)
    assert pflux.get_schedule(3, 256, shift=False) == jflux.get_schedule(3, 256, shift=False)
    z = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
    packed = pflux.pack_latents(torch.from_numpy(z))
    assert np.array_equal(packed.numpy(), np.asarray(jflux.pack_latents(jnp.asarray(z))))
    assert torch.equal(pflux.unpack_latents(packed, 64, 48), torch.from_numpy(z))
    noise = pflux.get_noise(torch.Generator().manual_seed(0), 2, 256, 240)
    assert tuple(noise.shape) == tuple(jflux.get_noise(jax.random.PRNGKey(0), 2, 256, 240).shape)
    assert dataclasses.asdict(pflux.flux_dev_params()) == \
        dataclasses.asdict(jflux.flux_dev_params())


def test_cross_attention_takes_the_einsum_path(monkeypatch):
    """``sdpa_token_major`` sends a cross-attention (k shorter than q: the
    IP-adapter's 4 image tokens) to the einsum path, never to the flash
    kernel, which takes q's length for k's; a self-attention at the same
    bf16 shape goes to flash."""
    calls = []
    real = fa.flash_attention

    def flash(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(fa, "flash_attention", flash)
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 2, 64)).astype(np.float32)).bfloat16()
               for n in (128, 4, 4))
    assert fa.sdpa_uses_flash(torch.bfloat16, 128, 2, 64)
    out = fa.sdpa_token_major(q, k, v)
    assert calls == [] and tuple(out.shape) == (1, 128, 128)
    att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0, -1)
    want = torch.einsum("bhqk,bkhd->bqhd", att, v.float()).reshape(1, 128, 128)
    assert float((out.float() - want).abs().max()) <= 2e-2
    fa.sdpa_token_major(q, q, q)
    assert calls == [(1, 128, 128)]
