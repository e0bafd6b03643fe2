"""The four CUDA kernels against their plain PyTorch versions, on the card,
at shapes the main path does not give them: ragged tiles, several heads,
other head dims and widths, exact ties.

Needs a CUDA card, nvcc and no JAX (the port's tests of the JAX package run
on the CPU); everything here skips where there is no card.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_cuda import gq_argmax_cuda
from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import (
    argmax_blocked, gq_scores_reference, score_operands)

pytestmark = pytest.mark.cuda

BF16_RTOL = BF16_ATOL = 1e-2  # fp32 summation order only; at most one bf16 ulp apart
STATS_RTOL = 1e-5             # the stats epilogue vs a float64 reduce of its own output
FLASH_ATOL = 2e-2             # the JAX package's bf16 attention bar
NEAR_TIE = 1e-5               # relative float64 score gap under which two GQ codes tie


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("rows,group,n", [(1000, 16, 65536), (700, 8, 300), (513, 4, 5000)])
def test_gq_argmax_matches_plain(gen, rows, group, n):
    mu = torch.randn((rows, group), generator=gen, device="cuda")
    std = torch.exp(0.5 * torch.randn((rows, group), generator=gen, device="cuda").clamp(-4, 1))
    cb = torch.randn((n, group), generator=gen, device="cuda")
    a, b = score_operands(mu, std, cb, 1.0)
    before = gq_argmax_cuda.launches
    got = gq_argmax_cuda(a, b)
    assert gq_argmax_cuda.launches == before + 1
    want = argmax_blocked(a, b)
    assert got.dtype == torch.int32 and int(got.max()) < n
    for r in (got != want).nonzero().flatten().tolist():
        pair = [int(got[r]), int(want[r])]
        s = gq_scores_reference(mu[r:r + 1].cpu().numpy(), std[r:r + 1].cpu().numpy(),
                                cb[pair].cpu().numpy())[0]
        assert abs(s[0] - s[1]) <= NEAR_TIE * max(1.0, abs(s[1])), (r, pair, s)


def test_gq_argmax_keeps_the_first_maximum(gen):
    """Duplicated columns force exact ties across tiles and chunks; all
    scores are negative, so a padded zero column would win if it could."""
    a = -torch.ones((600, 8), device="cuda")
    # eighths sum exactly in float32 in any order, so every tie is exact
    col = torch.randint(0, 64, (8, 4000), generator=gen, device="cuda").float() / 8
    b = torch.cat([col, col, col], dim=1)
    got = gq_argmax_cuda(a, b)
    assert torch.equal(got, argmax_blocked(a, b))
    assert torch.equal(got.long(), torch.argmax(a @ b, dim=1))
    assert int(got.max()) < 4000


def _conv_case(gen, shape, o, with_add):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    add = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) if with_add else None
    w = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (3 * c ** 0.5)).to(torch.bfloat16)
    bias = torch.randn((o,), generator=gen, device="cuda")
    return x, add, w, bias


def _check_conv(got, want):
    (y, stats), (y_p, _) = got, want
    assert y.shape == y_p.shape and y.dtype == torch.bfloat16
    d = (y.float() - y_p.float()).abs()
    assert bool((d <= BF16_ATOL + BF16_RTOL * y_p.float().abs()).all()), float(d.max())
    yd = y.double().flatten(1, 2)
    ref = torch.stack([yd.sum(1), (yd * yd).sum(1)], dim=1)
    scale = torch.stack([yd.abs().sum(1), (yd * yd).sum(1)], dim=1)
    assert float(((stats.double() - ref).abs() / scale).max()) <= STATS_RTOL


@pytest.mark.parametrize("shape,o,with_add", [
    ((2, 8, 12, 32), 128, False),    # 24 output pixels: one ragged M tile
    ((3, 18, 34, 64), 128, True),    # 153 output pixels: two tiles, the second ragged
    ((1, 32, 32, 32), 256, True),    # two output-channel tiles
])
def test_downsample_kernel_matches_plain(gen, shape, o, with_add):
    x, add, w, bias = _conv_case(gen, shape, o, with_add)
    before = down.downsample_conv3x3_gn_cuda.launches
    got = down.downsample_conv3x3_gn(x, w, bias, add)
    assert down.downsample_conv3x3_gn_cuda.launches == before + 1
    _check_conv(got, down.downsample_conv3x3_gn_plain(x, w, bias, add))


@pytest.mark.parametrize("shape,o,with_add", [
    ((2, 5, 7, 32), 128, False),     # 35 pixels per phase: one ragged tile
    ((1, 12, 20, 64), 256, True),    # two output-channel tiles, two M tiles
    ((2, 16, 16, 32), 128, True),
])
def test_upsample_kernel_matches_plain(gen, shape, o, with_add):
    x, add, w, bias = _conv_case(gen, shape, o, with_add)
    before = up.upsample_nearest_conv3x3_gn_cuda.launches
    got = up.upsample_nearest_conv3x3_gn(x, w, bias, add)
    assert up.upsample_nearest_conv3x3_gn_cuda.launches == before + 1
    _check_conv(got, up.upsample_nearest_conv3x3_gn_plain(x, w, bias, add))


@pytest.mark.parametrize("b,l,h,d", [(2, 128, 4, 64), (1, 192, 2, 128), (2, 64, 1, 256),
                                     (1, 256, 1, 512)])
def test_flash_kernel_matches_plain(gen, b, l, h, d):
    q, k, v = (torch.randn((b, l, h * d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention(q, k, v, d ** -0.5, h)
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, d ** -0.5, h)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL


@pytest.mark.parametrize("l,c,h", [(100, 64, 1), (128, 96, 1)])
def test_flash_kernel_refuses_unsupported_shapes(gen, l, c, h):
    q = torch.zeros((1, l, c), dtype=torch.bfloat16, device="cuda")
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q, 0.125, h)
    assert fa.flash_attention_cuda.launches == before


def test_resample_kernels_refuse_unsupported_widths(gen):
    x = torch.zeros((1, 8, 8, 48), dtype=torch.bfloat16, device="cuda")  # C not a multiple of 32
    w = torch.zeros((3, 3, 48, 128), dtype=torch.bfloat16, device="cuda")
    for op in (down.downsample_conv3x3_gn_cuda, up.upsample_nearest_conv3x3_gn_cuda):
        with pytest.raises(ValueError):
            op(x, w, torch.zeros(128, device="cuda"))


def test_gq_inputs_stay_on_the_card(gen):
    a = torch.zeros((4, 8), device="cuda")
    with pytest.raises(ValueError):
        gq_argmax_cuda(a, torch.zeros((8, 16)))
