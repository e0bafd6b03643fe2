"""The float32 fused GroupNorm + swish + conv on split TF32
(``csrc/conv_gn_f32_sm90.cuh``, ``ops/fused_gn_conv.py:gn_conv_f32_plan``),
on the CPU.

The plan's tiling against the C source's constants and the card (the
float32 engine's (2, 32^2, 512 -> 512) in one wave on 132 SMs, a block's
shared memory); the weight pre-pass's layout (``weight_planes_plain``:
(tap, plane, O, C), hi and lo TF32 values by bit masking, round to nearest
with ties away from zero); and a torch model of the kernel's arithmetic
(the transform split into hi and lo planes, each 32-channel K step's nine
taps of three TF32 passes from a zeroed accumulator, the K steps added in
order in float32, + bias, + residual) against the JAX package's float32
``fused_gn_swish_conv`` (its Pallas kernel in interpret mode, as
``tests/test_fused_gn_conv.py`` runs it) within the card's 1e-4 bar at C =
O = 512, K = 4608, where one TF32 pass misses it.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_from_gaussian_vae_tpu.ops import fused_gn_conv as jfused
from vqvae_from_gaussian_vae_tpu_torch.ops import fused_gn_conv as fgc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "vqvae_from_gaussian_vae_tpu_torch", "csrc")
TOL = 1e-4  # the card's bar for the float32 kernel (chip_smoke.py FUSED_F32_TOL)


def _constants(name: str) -> dict:
    text = open(os.path.join(CSRC, name)).read()
    return {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)[,;]", text)}


def test_plan_tiling_is_the_kernels():
    k, ig = _constants("conv_gn_f32_sm90.cuh"), _constants("conv_igemm_sm90.cuh")
    assert (ig["kIgGnTileH"], ig["kIgGnTileW"]) == fgc.F32_TILE
    assert (k["kGf32BN"], k["kGf32BK"], k["kGf32Stages"], k["kGf32HaloStages"]) == \
        (fgc.F32_TILE_N, fgc.F32_TILE_K, fgc.F32_STAGES, fgc.F32_HALO_STAGES)
    # a K step's channels are one 128-byte row of float32 (the 128-byte swizzle)
    assert fgc.F32_TILE_K * 4 == 128


def test_the_float32_engines_shape_fills_the_card_in_one_wave():
    plan = fgc.gn_conv_f32_plan(2, 32, 32, 512, 512)
    # 2 samples x 8 pixel tiles x 8 channel tiles, one block an SM
    assert (plan.tiles, plan.n_tiles, plan.k_steps) == (8, 8, 16)
    assert 0.95 * 132 <= plan.blocks == 128 <= 132
    # three halo buffers of two 23,552-byte planes, four 16 KB weight stages
    assert plan.smem == 3 * 2 * 23_552 + 4 * 16_384 + 112 + 1024 == 207_984 <= 232_448
    assert plan.scratch * 4 == 9 * 2 * 512 * 512 * 4 == 18_874_368  # the weights' planes
    # the small shape: one channel tile a pixel tile; ragged grids round up
    assert fgc.gn_conv_f32_plan(2, 32, 32, 64, 64).blocks == 16
    assert fgc.gn_conv_f32_plan(1, 9, 21, 96, 72) == fgc.GnConvF32Plan(4, 2, 3, 8, 207_984,
                                                                        9 * 2 * 72 * 96)


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, in float64 arithmetic on the magnitude."""
    m, e = np.frexp(np.abs(x.astype(np.float64)))
    return (np.sign(x) * np.ldexp(np.floor(m * 2048 + 0.5) / 2048, e)).astype(np.float32)


def test_weight_planes_are_the_transposed_tf32_split():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 3, 40, 24)) * np.exp(rng.uniform(-8, 8, (3, 3, 40, 24))))
    w = w.astype(np.float32)
    # ties: exactly half a TF32 ulp above a TF32 value rounds away from zero
    w[0, 0, 0, :2] = np.float32(1 + 2.0 ** -11), np.float32(-(1 + 3 * 2.0 ** -11))
    wt = fgc.weight_planes_plain(torch.from_numpy(w))
    assert wt.shape == (9, 2, 24, 40) and wt.dtype == torch.float32 and wt.is_contiguous()
    hi, lo = wt[:, 0].numpy(), wt[:, 1].numpy()
    want = w.reshape(9, 40, 24).transpose(0, 2, 1)
    np.testing.assert_array_equal(hi, _tf32_reference(want))
    np.testing.assert_array_equal(lo, _tf32_reference(want - hi))
    assert hi[0, 0, 0] == np.float32(1 + 2.0 ** -10) and hi[0, 1, 0] == -np.float32(1 + 2.0 ** -9)
    for plane in (hi, lo):  # TF32 values: the low 13 mantissa bits are zero
        assert not (plane.view(np.int32) & 0x1FFF).any()
    # hi + lo keeps about 22 bits of each weight
    assert np.all(np.abs(hi.astype(np.float64) + lo - want) <= 2.0 ** -21 * np.abs(want))


def _kernel_model(x, gamma, beta, w, bias, residual, passes=3):
    """The kernel's arithmetic in torch: h = swish(x scale + shift) in
    float32, zero-padded, split into hi and lo; each 32-channel K step's
    nine taps of lo.hi + hi.lo + hi.hi (or hi.hi alone, passes=1) summed
    exactly (float64) from zero and rounded once, the K steps added in order
    in float32; + bias, + residual."""
    scale, shift = fgc.gn_affine(x, gamma, beta)
    h = x * scale[:, None, None, :] + shift[:, None, None, :]
    h = (h / (1 + torch.exp(-h))).permute(0, 3, 1, 2)
    h_hi = fgc.tf32_round(h)
    h_lo = fgc.tf32_round(h - h_hi)
    wt = fgc.weight_planes_plain(w)  # (9, 2, O, C)
    o, c = wt.shape[2], wt.shape[3]

    def conv(a, plane, ch):  # the nine taps' products of one plane pair, exact
        k = wt[:, plane, :, ch].double().permute(1, 2, 0).reshape(o, ch.stop - ch.start, 3, 3)
        return F.conv2d(a[:, ch].double(), k, padding=1)

    total = torch.zeros((x.shape[0], o) + x.shape[1:3])
    for c0 in range(0, c, fgc.F32_TILE_K):
        ch = slice(c0, min(c, c0 + fgc.F32_TILE_K))
        part = conv(h_hi, 0, ch)
        if passes == 3:
            part = conv(h_lo, 0, ch) + conv(h_hi, 1, ch) + part
        total = total + part.float()
    y = total.permute(0, 2, 3, 1) + bias
    return y if residual is None else y + residual


@pytest.fixture(scope="module")
def wide_case():
    """C = O = 512 (K = 4608) on an 8 x 8 grid, with a residual, and the JAX
    package's float32 output for it."""
    rng = np.random.default_rng(7)
    b, h, w, c, o = 1, 8, 8, 512, 512
    arrs = [2 * rng.standard_normal((b, h, w, c)) + 0.3, 1 + 0.3 * rng.standard_normal(c),
            0.3 * rng.standard_normal(c), rng.standard_normal((3, 3, c, o)) / (3 * c ** 0.5),
            0.1 * rng.standard_normal(o), rng.standard_normal((b, h, w, o))]
    arrs = [a.astype(np.float32) for a in arrs]
    want = jfused.fused_gn_swish_conv(*map(jnp.asarray, arrs[:5]), block_h=8, interpret=True,
                                      residual=jnp.asarray(arrs[5]))
    return [torch.from_numpy(a) for a in arrs], torch.from_numpy(np.array(want))


def _err_over_bar(got, want) -> float:
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


def test_split_tf32_model_meets_the_bar_at_k_4608_and_one_pass_misses_it(wide_case):
    args, want = wide_case
    assert _err_over_bar(_kernel_model(*args), want) <= 0.1
    assert _err_over_bar(_kernel_model(*args, passes=1), want) > 1.0
    # the plain version the card holds the kernel to agrees with both
    plain = fgc.fused_gn_swish_conv_plain(*args)
    assert _err_over_bar(plain, want) <= 0.1 and _err_over_bar(_kernel_model(*args), plain) <= 0.1
