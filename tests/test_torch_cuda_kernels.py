"""The CUDA kernels against their plain PyTorch versions, on the card, at
shapes the main paths do not give them: ragged tiles and row counts,
several heads, other head dims and widths, exact ties.

Needs a CUDA card, nvcc and no JAX (the port's tests of the JAX package run
on the CPU); everything here skips where there is no card.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from vqvae_from_gaussian_vae_tpu_torch.ops import conv3x3_train as c3
from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl
from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as fx
from vqvae_from_gaussian_vae_tpu_torch.ops import fused_gn_conv as fgc
from vqvae_from_gaussian_vae_tpu_torch.ops import gn_swish_bwd as gsb
from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln
from vqvae_from_gaussian_vae_tpu_torch.ops import ln_matmul as lmm
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
    ((2, 16, 20, 64), 256, False),   # no add at the 256-channel tile
    ((2, 64, 64, 512), 512, True),   # the smallest main-path shape at bs 2
])
def test_downsample_kernel_matches_plain(gen, shape, o, with_add):
    x, add, w, bias = _conv_case(gen, shape, o, with_add)
    before = down.downsample_conv3x3_gn_cuda.launches
    got = down.downsample_conv3x3_gn(x, w, bias, add)
    assert down.downsample_conv3x3_gn_cuda.launches == before + 1
    _check_conv(got, down.downsample_conv3x3_gn_plain(x, w, bias, add))


@pytest.mark.parametrize("shape,o,with_add", [
    ((3, 18, 34, 64), 128, True),    # two blocks an SM, ragged tiles
    ((2, 64, 64, 512), 512, True),   # one block an SM, the smallest main-path shape at bs 2
    ((2, 16, 20, 64), 256, False),
])
def test_downsample_kernels_are_bit_reproducible(gen, shape, o, with_add):
    """y, the statistics and dx repeat bit for bit: fixed summation orders,
    no float atomics."""
    x, add, w, bias = _conv_case(gen, shape, o, with_add)
    y, stats = down.downsample_conv3x3_gn_cuda(x, w, bias, add)
    y2, stats2 = down.downsample_conv3x3_gn_cuda(x, w, bias, add)
    assert torch.equal(y, y2) and torch.equal(stats, stats2)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(torch.bfloat16)
    dx = down.downsample_dgrad_cuda(g, w)
    assert torch.equal(dx, down.downsample_dgrad_cuda(g, w))


@pytest.mark.parametrize("shape,o,with_add", [
    ((2, 5, 7, 32), 128, False),     # 35 pixels per phase: one ragged tile
    ((1, 12, 20, 64), 256, True),    # two output-channel tiles, two M tiles
    ((2, 16, 16, 32), 128, True),
    ((1, 1, 1, 32), 128, True),      # one pixel: every tap but one off the image
    ((2, 9, 21, 96), 384, False),    # ragged both ways, three N tiles of 128
    ((2, 32, 32, 512), 512, False),  # the smallest main-path shape at bs 2
])
def test_upsample_kernel_matches_plain(gen, shape, o, with_add):
    x, add, w, bias = _conv_case(gen, shape, o, with_add)
    before = up.upsample_nearest_conv3x3_gn_cuda.launches
    got = up.upsample_nearest_conv3x3_gn(x, w, bias, add)
    assert up.upsample_nearest_conv3x3_gn_cuda.launches == before + 1
    _check_conv(got, up.upsample_nearest_conv3x3_gn_plain(x, w, bias, add))


def test_upsample_and_fused_gn_kernels_are_bit_reproducible(gen):
    """The upsample forward's y and statistics and the fused GN conv's y
    repeat bit for bit (the Hopper bodies, the bf16 implicit GEMM and the
    float32 split TF32: fixed summation orders, no float atomics), with and
    without the add or the residual."""
    for shape, o, with_add in [((2, 9, 21, 96), 384, True), ((2, 32, 32, 512), 512, False)]:
        x, add, w, bias = _conv_case(gen, shape, o, with_add)
        y, stats = up.upsample_nearest_conv3x3_gn_cuda(x, w, bias, add)
        y2, stats2 = up.upsample_nearest_conv3x3_gn_cuda(x, w, bias, add)
        assert torch.equal(y, y2) and torch.equal(stats, stats2)
    for shape, o, dtype, residual in [((2, 9, 21, 32), 136, torch.bfloat16, True),
                                      ((2, 32, 32, 512), 512, torch.bfloat16, False),
                                      ((2, 32, 32, 512), 512, torch.float32, True),
                                      ((1, 9, 21, 96), 72, torch.float32, False)]:
        args = _gn_conv_case(gen, shape, o, dtype, residual)
        assert torch.equal(fgc.fused_gn_swish_conv_cuda(*args), fgc.fused_gn_swish_conv_cuda(*args))


def test_fused_gn_conv_float32_kernel_takes_a_partial_k_step(gen):
    """C = 36 through the affine entry: the last 32-channel K step is partly
    past C (the halo box's zero fill, the transform's 0), held to a float64
    reference."""
    import torch.nn.functional as F

    b, h, wd, c, o = 1, 9, 21, 36, 40
    x = torch.randn((b, h, wd, c), generator=gen, device="cuda")
    scale = 1 + 0.3 * torch.randn((b, c), generator=gen, device="cuda")
    shift = 0.3 * torch.randn((b, c), generator=gen, device="cuda")
    w = torch.randn((3, 3, c, o), generator=gen, device="cuda") / (3 * c ** 0.5)
    bias = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    got = fgc.fused_gn_swish_conv_affine_cuda(x, scale, shift, w, bias)
    hd = x.double() * scale.double()[:, None, None] + shift.double()[:, None, None]
    hd = (hd * torch.sigmoid(hd)).permute(0, 3, 1, 2)
    want = F.conv2d(hd, w.double().permute(3, 2, 0, 1), bias.double(), padding=1)
    _close(got, want.permute(0, 2, 3, 1).float().contiguous(), FUSED_F32_TOL)


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


LN_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}  # summation order only


def _ln_case(gen, rows, c, dtype):
    x = (2 * torch.randn((rows, c), generator=gen, device="cuda") + 0.5).to(dtype)
    d = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
    w = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
    b = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    return x, d, w, b


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", [(13, 8), (1000, 200), (77, 768), (5, 1024), (9, 4096)])
def test_layer_norm_kernels_match_plain(gen, rows, c, dtype):
    x, d, w, b = _ln_case(gen, rows, c, dtype)
    before = (ln.layer_norm_cuda.launches, ln.layer_norm_add_cuda.launches)
    y = ln.layer_norm(x, w, b)
    s, y2 = ln.layer_norm_add(x, d, w, b)
    assert (ln.layer_norm_cuda.launches, ln.layer_norm_add_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    _close(y, ln.layer_norm_plain(x, w, b), LN_TOL[dtype])
    s_p, y2_p = ln.layer_norm_add_plain(x, d, w, b)
    assert torch.equal(s, s_p)
    _close(y2, y2_p, LN_TOL[dtype])


@pytest.mark.parametrize("c", [12, 4104])
def test_layer_norm_kernels_refuse_unsupported_widths(gen, c):
    x = torch.zeros((4, c), dtype=torch.bfloat16, device="cuda")
    w, b = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    before = (ln.layer_norm_cuda.launches, ln.layer_norm_add_cuda.launches)
    with pytest.raises(ValueError):
        ln.layer_norm_cuda(x, w, b)
    with pytest.raises(ValueError):
        ln.layer_norm_add_cuda(x, x, w, b)
    assert (ln.layer_norm_cuda.launches, ln.layer_norm_add_cuda.launches) == before


def test_layer_norm_kernels_refuse_strided_rows(gen):
    x = torch.zeros((4, 512), dtype=torch.bfloat16, device="cuda")[:, :256]
    w, b = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")
    with pytest.raises(ValueError):
        ln.layer_norm_cuda(x, w, b)


@pytest.mark.parametrize("l", [64, 192, 1024])
@pytest.mark.parametrize("h,d", [(12, 64), (4, 128)])
def test_packed_flash_kernel_matches_plain(gen, l, h, d):
    qkv = torch.randn((2, l, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    before = fa.flash_attention_qkv_cuda.launches
    got = fa.flash_attention_qkv(qkv, d ** -0.5, h)
    assert fa.flash_attention_qkv_cuda.launches == before + 1
    want = fa.flash_attention_qkv_plain(qkv, d ** -0.5, h)
    assert got.shape == want.shape == (2, l, h * d)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL
    # the same kernel on contiguous copies of q, k, v gives the same bits
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    assert torch.equal(fa.flash_attention_cuda(q, k, v, d ** -0.5, h), got)


@pytest.mark.parametrize("l,h,d", [(100, 2, 64), (128, 4, 32), (128, 1, 96)])
def test_packed_flash_kernel_refuses_unsupported_shapes(gen, l, h, d):
    qkv = torch.zeros((1, l, 3 * h * d), dtype=torch.bfloat16, device="cuda")
    before = fa.flash_attention_qkv_cuda.launches
    with pytest.raises(ValueError):
        fa.flash_attention_qkv_cuda(qkv, 0.125, h)
    assert fa.flash_attention_qkv_cuda.launches == before


def test_packed_flash_kernel_refuses_strided_qkv(gen):
    qkv = torch.zeros((1, 64, 2 * 3 * 64), dtype=torch.bfloat16, device="cuda")[..., ::2]
    with pytest.raises(ValueError):
        fa.flash_attention_qkv_cuda(qkv, 0.125, 1)


# --- backward kernels and the training forward --------------------------------

LN_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # summation order only


def _ln_bwd_case(gen, rows, c, dtype):
    x, d, w, _ = _ln_case(gen, rows, c, dtype)
    dy = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
    return x, d, w, dy


def _close_rel(got, want, tol):
    """Elementwise within tol of want's largest magnitude: dweight and
    dbias are sums over all rows, so their error scales with the sum."""
    scale = float(want.float().abs().max()) or 1.0
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", [(13, 8), (1000, 768), (77, 200), (3000, 4096), (16384, 768)])
def test_layer_norm_bwd_kernel_matches_plain(gen, rows, c, dtype):
    x, _, w, dy = _ln_bwd_case(gen, rows, c, dtype)
    before = ln.layer_norm_bwd_cuda.launches
    dx, dw, db = ln.layer_norm_bwd_cuda(x, w, dy)
    assert ln.layer_norm_bwd_cuda.launches == before + 1
    dx_p, dw_p, db_p = ln.layer_norm_bwd_plain(x, w, dy)
    _close(dx, dx_p, LN_BWD_TOL[dtype])
    assert dw.dtype == db.dtype == torch.float32
    _close_rel(dw, dw_p, LN_BWD_TOL[torch.float32])
    _close_rel(db, db_p, LN_BWD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", [(13, 8), (1000, 768), (77, 200), (3000, 4096)])
def test_layer_norm_add_bwd_kernel_matches_plain(gen, rows, c, dtype):
    x, d, w, dy = _ln_bwd_case(gen, rows, c, dtype)
    s = (x.float() + d.float()).to(dtype)
    ds_in = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
    before = ln.layer_norm_add_bwd_cuda.launches
    dx, dw, db = ln.layer_norm_add_bwd_cuda(s, w, dy, ds_in)
    assert ln.layer_norm_add_bwd_cuda.launches == before + 1
    dx_p, dw_p, db_p = ln.layer_norm_bwd_plain(s, w, dy, ds_in=ds_in)
    _close(dx, dx_p, LN_BWD_TOL[dtype])
    _close_rel(dw, dw_p, LN_BWD_TOL[torch.float32])
    _close_rel(db, db_p, LN_BWD_TOL[torch.float32])


def test_layer_norm_bwd_kernels_are_bit_reproducible(gen):
    x, _, w, dy = _ln_bwd_case(gen, 16384, 768, torch.bfloat16)
    first = ln.layer_norm_bwd_cuda(x, w, dy)
    second = ln.layer_norm_bwd_cuda(x, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_layer_norm_autograd_runs_the_kernels(gen):
    x, d, w, dy = _ln_bwd_case(gen, 64, 256, torch.bfloat16)
    x, d, w = (t.clone().requires_grad_() for t in (x, d, w))
    b = torch.zeros(256, device="cuda", requires_grad=True)
    before = (ln.layer_norm_bwd_cuda.launches, ln.layer_norm_add_bwd_cuda.launches)
    s, y = ln.layer_norm_add(x, d, w, b)
    y2 = ln.layer_norm(s, w, b)
    (y.float() * dy.float()).sum().add((y2.float() * dy.float()).sum()).backward()
    assert (ln.layer_norm_bwd_cuda.launches, ln.layer_norm_add_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(x.grad, d.grad) and w.grad.dtype == torch.float32


FLASH_BWD_REL = 2e-2  # max error over max |grad|: the JAX package's flash bar


def _rel_max(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("l", [64, 192, 1024])
@pytest.mark.parametrize("h,d", [(12, 64), (2, 128)])
def test_packed_flash_training_forward_matches_plain(gen, l, h, d):
    qkv = torch.randn((2, l, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    before = fa.flash_attention_qkv_res_cuda.launches
    o, z = fa.flash_attention_qkv_res_cuda(qkv, d ** -0.5, h)
    assert fa.flash_attention_qkv_res_cuda.launches == before + 1
    o_p, z_p = fa.flash_attention_qkv_res_plain(qkv, d ** -0.5, h)
    assert z.shape == (2, h, l) and z.dtype == torch.float32
    assert float((z - z_p).abs().max()) <= 1e-3 * max(1.0, float(z_p.abs().max()))
    # the same kernel as the inference entry: o is bit-equal
    assert torch.equal(o, fa.flash_attention_qkv_cuda(qkv, d ** -0.5, h))
    assert float((o.float() - o_p.float()).abs().max()) <= FLASH_ATOL


@pytest.mark.parametrize("l", [64, 192, 1024])
@pytest.mark.parametrize("b,h,d", [(2, 12, 64), (1, 2, 128), (1, 2, 256)])
def test_packed_flash_bwd_kernel_matches_plain(gen, l, b, h, d):
    qkv = torch.randn((b, l, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, l, h * d), generator=gen, device="cuda").to(torch.bfloat16)
    o, z = fa.flash_attention_qkv_res_cuda(qkv, d ** -0.5, h)
    before = fa.flash_attention_qkv_bwd_cuda.launches
    got = fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, d ** -0.5, h)
    assert fa.flash_attention_qkv_bwd_cuda.launches == before + 1
    want = fa.flash_attention_qkv_bwd_plain(qkv, o, z, do, d ** -0.5, h)
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    for g, w in zip(got.chunk(3, dim=-1), want.chunk(3, dim=-1)):  # dq, dk, dv
        assert _rel_max(g, w) <= FLASH_BWD_REL


@pytest.mark.parametrize("h,d", [(12, 64), (2, 256), (1, 512)])
def test_packed_flash_bwd_kernel_is_bit_reproducible(gen, h, d):
    """The packed backward on either body (D = 64: wgmma; 256 and 512: the
    wide body, a cluster of two blocks at 512) gives equal bits twice."""
    qkv = torch.randn((2, 1024, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn((2, 1024, h * d), generator=gen, device="cuda").to(torch.bfloat16)
    o, z = fa.flash_attention_qkv_res_cuda(qkv, d ** -0.5, h)
    first = fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, d ** -0.5, h)
    assert torch.equal(first, fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, d ** -0.5, h))


def test_packed_flash_autograd_runs_the_kernels(gen):
    qkv = torch.randn((1, 128, 3 * 256), generator=gen, device="cuda").to(torch.bfloat16)
    qkv.requires_grad_()
    before = (fa.flash_attention_qkv_res_cuda.launches, fa.flash_attention_qkv_bwd_cuda.launches,
              fa.flash_attention_qkv_cuda.launches)
    fa.flash_attention_qkv(qkv, 0.125, 4).float().square().sum().backward()
    assert (fa.flash_attention_qkv_res_cuda.launches, fa.flash_attention_qkv_bwd_cuda.launches,
            fa.flash_attention_qkv_cuda.launches) == (before[0] + 1, before[1] + 1, before[2])
    assert qkv.grad.shape == qkv.shape and bool(torch.isfinite(qkv.grad.float()).all())


def test_kernels_without_a_backward_refuse_grad(gen):
    """No wrapper returns a tensor cut off from autograd: every direct launch
    raises when a gradient is wanted (the forward launches have their
    backward only inside the public ops' autograd Functions, and the
    backward launches have no double backward); the public ops then run
    their Functions."""
    q = torch.zeros((1, 64, 512), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    qkv = torch.zeros((1, 64, 3 * 128), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    x, _, w, bias = _conv_case(gen, (1, 8, 8, 32), 128, False)
    w.requires_grad_()
    g_down = torch.zeros((1, 4, 4, 128), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    g_up = torch.zeros((1, 16, 16, 128), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    z = torch.zeros((1, 1, 64), device="cuda")
    launches = [
        lambda: fa.flash_attention_cuda(q, q, q, 512 ** -0.5, 1),
        lambda: fa.flash_attention_res_cuda(q, q, q, 512 ** -0.5, 1),
        lambda: fa.flash_attention_bwd_cuda(q, q, q, q, z, q, 512 ** -0.5, 1),
        lambda: fa.flash_attention_qkv_cuda(qkv, 0.125, 2),
        lambda: down.downsample_conv3x3_gn_cuda(x, w, bias),
        lambda: up.upsample_nearest_conv3x3_gn_cuda(x, w, bias),
        lambda: down.downsample_dgrad_cuda(g_down, w),
        lambda: down.downsample_wgrad_cuda(x, g_down),
        lambda: up.upsample_dgrad_cuda(g_up, up.phase_kernels(w)),
        lambda: up.upsample_wgrad_cuda(x, g_up),
    ]
    for launch in launches:
        with pytest.raises(RuntimeError, match="no backward"):
            launch()
    # the public ops take their autograd Functions under grad
    assert down.downsample_conv3x3_gn(x, w, bias)[0].grad_fn is not None
    assert up.upsample_nearest_conv3x3_gn(x, w, bias)[0].grad_fn is not None
    assert fa.flash_attention(q, q, q, 512 ** -0.5, 1).grad_fn is not None
    with torch.no_grad():  # without a gradient the forward launches run
        down.downsample_conv3x3_gn(x, w, bias)
        fa.flash_attention(q, q, q, 512 ** -0.5, 1)


# --- the resample backward (dgrad, wgrad) and the unpacked flash backward -----

WGRAD_REL = 1e-3  # float32 sums of exact bf16 products in another order, over max |dw|


def _bwd_case(gen, shape, o, up_op):
    """x (B, H, W, C), w (3, 3, C, O) and a cotangent g of the op's output."""
    b, h, wd, c = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (3 * c ** 0.5)).to(torch.bfloat16)
    gshape = (b, 2 * h, 2 * wd, o) if up_op else (b, h // 2, wd // 2, o)
    g = torch.randn(gshape, generator=gen, device="cuda").to(torch.bfloat16)
    return x, w, g


@pytest.mark.parametrize("shape,o", [
    ((2, 10, 14, 32), 128),   # 35 output pixels: one ragged M tile; dgrad N = 32 < 128
    ((1, 2, 2, 256), 512),    # one output pixel: a single band
    ((3, 18, 34, 256), 128),  # 153 output pixels: two M tiles, the second ragged
    ((2, 32, 32, 32), 512),
    ((1, 2, 30, 136), 96),    # one cotangent row; wgrad C, O not multiples of 64
    ((2, 18, 42, 72), 160),   # wgrad tiles of 2 x 32 ragged in H and W
    ((2, 64, 64, 512), 512),  # the smallest main-path shape at bs 2
])
def test_downsample_bwd_kernels_match_plain(gen, shape, o):
    x, w, g = _bwd_case(gen, shape, o, False)
    before = (down.downsample_dgrad_cuda.launches, down.downsample_wgrad_cuda.launches)
    dx = down.downsample_dgrad_cuda(g, w)
    dw = down.downsample_wgrad_cuda(x, g)
    assert (down.downsample_dgrad_cuda.launches, down.downsample_wgrad_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    _close(dx, down.downsample_dgrad_plain(g, w), BF16_RTOL)
    assert dw.shape == (3, 3, shape[-1], o) and dw.dtype == torch.float32
    _close_rel(dw, down.downsample_wgrad_plain(x, g), WGRAD_REL)
    assert torch.equal(dw, down.downsample_wgrad_cuda(x, g))


@pytest.mark.parametrize("shape,o", [
    ((2, 5, 7, 32), 128),     # 35 pixels: one ragged M tile
    ((1, 1, 1, 256), 512),    # one low-resolution pixel: every halo masked
    ((1, 12, 20, 256), 128),  # two M tiles, two N tiles in dgrad
    ((2, 16, 16, 32), 512),
    ((1, 1, 9, 136), 96),     # one low-resolution row; wgrad C, O not multiples of 64
    ((2, 9, 21, 72), 160),    # wgrad tiles of 2 x 32 ragged in H and W
    ((2, 32, 32, 512), 512),  # the smallest main-path shape at bs 2
])
def test_upsample_bwd_kernels_match_plain(gen, shape, o):
    x, w, g = _bwd_case(gen, shape, o, True)
    k22 = up.phase_kernels(w)
    before = (up.upsample_dgrad_cuda.launches, up.upsample_wgrad_cuda.launches)
    dx = up.upsample_dgrad_cuda(g, k22)
    dk22 = up.upsample_wgrad_cuda(x, g)
    assert (up.upsample_dgrad_cuda.launches, up.upsample_wgrad_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    _close(dx, up.upsample_dgrad_plain(g, k22), BF16_RTOL)
    assert dk22.shape == (2, 2, 2, 2, shape[-1], o) and dk22.dtype == torch.float32
    _close_rel(dk22, up.upsample_wgrad_plain(x, g), WGRAD_REL)
    assert torch.equal(dk22, up.upsample_wgrad_cuda(x, g))


def test_resample_bwd_kernels_refuse_unsupported_widths(gen):
    x, w, g = _bwd_case(gen, (1, 8, 8, 32), 48, False)  # O not a multiple of 32
    with pytest.raises(ValueError):
        down.downsample_dgrad_cuda(g, w)
    x, w, g = _bwd_case(gen, (1, 4, 4, 12), 128, True)  # C not a multiple of 8
    with pytest.raises(ValueError):
        up.upsample_wgrad_cuda(x, g)
    with pytest.raises(ValueError):
        up.upsample_dgrad_cuda(g.float(), up.phase_kernels(w))


@pytest.mark.parametrize("op", ["down", "up"])
@pytest.mark.parametrize("with_add", [False, True])
def test_resample_autograd_runs_the_kernels(gen, op, with_add):
    """Under grad the public op runs its forward, dgrad and wgrad kernels
    once each, folds the statistics' cotangent, and sends dx to x and add;
    the gradients agree with float32 autograd of the plain forward on the
    same bf16 values."""
    shape = (2, 16, 16, 32)
    x, w, _ = _bwd_case(gen, shape, 128, op == "up")
    add = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) if with_add else None
    bias = torch.randn((128,), generator=gen, device="cuda")
    public = down.downsample_conv3x3_gn if op == "down" else up.upsample_nearest_conv3x3_gn
    plain = down.downsample_conv3x3_gn_plain if op == "down" else \
        up.upsample_nearest_conv3x3_gn_plain
    counters = ((down.downsample_conv3x3_gn_cuda, down.downsample_dgrad_cuda,
                 down.downsample_wgrad_cuda) if op == "down" else
                (up.upsample_nearest_conv3x3_gn_cuda, up.upsample_dgrad_cuda,
                 up.upsample_wgrad_cuda))
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
    a = None if add is None else add.clone().requires_grad_()
    y, stats = public(leaves[0], leaves[1], leaves[2], a)
    gy = torch.randn(y.shape, generator=gen, device="cuda")
    gs = torch.randn(stats.shape, generator=gen, device="cuda") / y[0, ..., 0].numel()
    ((y.float() * gy).sum() + (stats * gs).sum()).backward()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    ref = [t.float().requires_grad_() for t in (x, w, bias)]
    ra = None if add is None else add.float().requires_grad_()
    y32, s32 = plain(ref[0], ref[1], ref[2], ra)
    ((y32 * gy).sum() + (s32 * gs).sum()).backward()
    for got, want in zip(leaves, ref):
        _close_rel(got.grad, want.grad, 2e-2)
    if add is not None:
        assert torch.equal(a.grad, leaves[0].grad)


@pytest.mark.parametrize("b,l,h,d", [(2, 64, 2, 128), (1, 256, 4, 128), (2, 128, 1, 512),
                                     (1, 1024, 1, 512), (2, 192, 2, 256), (16, 1024, 1, 512)])
def test_flash_training_forward_and_bwd_match_plain(gen, b, l, h, d):
    q, k, v, do = (torch.randn((b, l, h * d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    before = (fa.flash_attention_res_cuda.launches, fa.flash_attention_bwd_cuda.launches)
    o, z = fa.flash_attention_res_cuda(q, k, v, scale, h)
    o_p, z_p = fa.flash_attention_res_plain(q, k, v, scale, h)
    assert z.shape == (b, h, l) and z.dtype == torch.float32
    assert float((z - z_p).abs().max()) <= 1e-3 * max(1.0, float(z_p.abs().max()))
    assert torch.equal(o, fa.flash_attention_cuda(q, k, v, scale, h))
    assert float((o.float() - o_p.float()).abs().max()) <= FLASH_ATOL
    got = fa.flash_attention_bwd_cuda(q, k, v, o, z, do, scale, h)
    assert (fa.flash_attention_res_cuda.launches, fa.flash_attention_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, o, z, do, scale, h)
    for g, w in zip(got, want):  # dq, dk, dv
        assert g.shape == q.shape and g.dtype == torch.bfloat16
        assert _rel_max(g, w) <= FLASH_BWD_REL
    again = fa.flash_attention_bwd_cuda(q, k, v, o, z, do, scale, h)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_packed_flash_bwd_kernel_takes_d512(gen):
    """The packed entry shares the backward kernels: the wide body at D = 512
    (a cluster of two blocks a row) and at D = 256, at token stride 3C,
    matching the plain version and repeating bit for bit."""
    for h, d in ((1, 512), (2, 512), (1, 256)):
        assert fa.flash_bwd_plan("packed", 1, h, 128, 128, d, 3 * h * d).body == "wgmma_wide"
        qkv = torch.randn((1, 128, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        do = torch.randn((1, 128, h * d), generator=gen, device="cuda").to(torch.bfloat16)
        o, z = fa.flash_attention_qkv_res_cuda(qkv, d ** -0.5, h)
        got = fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, d ** -0.5, h)
        want = fa.flash_attention_qkv_bwd_plain(qkv, o, z, do, d ** -0.5, h)
        for g, w in zip(got.chunk(3, dim=-1), want.chunk(3, dim=-1)):
            assert _rel_max(g, w) <= FLASH_BWD_REL
        assert torch.equal(got, fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, d ** -0.5, h))


def test_unpacked_flash_autograd_runs_the_kernels(gen):
    q, k, v = (torch.randn((1, 128, 512), generator=gen, device="cuda").to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    before = (fa.flash_attention_res_cuda.launches, fa.flash_attention_bwd_cuda.launches,
              fa.flash_attention_cuda.launches)
    fa.flash_attention(q, k, v, 512 ** -0.5, 1).float().square().sum().backward()
    assert (fa.flash_attention_res_cuda.launches, fa.flash_attention_bwd_cuda.launches,
            fa.flash_attention_cuda.launches) == (before[0] + 1, before[1] + 1, before[2])
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    p = torch.softmax(ref[0] @ ref[1].transpose(1, 2) * 512 ** -0.5, dim=-1)
    (p @ ref[2]).square().sum().backward()
    for got, want in zip((q, k, v), ref):
        assert _rel_max(got.grad, want.grad) <= FLASH_BWD_REL


FUSED_F32_TOL = 1e-4  # the float32 variant: float32 sums in another order


def _gn_conv_case(gen, shape, o, dtype, residual):
    b, h, wd, c = shape
    x = (2 * torch.randn(shape, generator=gen, device="cuda") + 0.3).to(dtype)
    gamma = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
    beta = 0.3 * torch.randn((c,), generator=gen, device="cuda")
    w = torch.randn((3, 3, c, o), generator=gen, device="cuda") / (3 * c ** 0.5)
    bias = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    res = torch.randn((b, h, wd, o), generator=gen, device="cuda").to(dtype) if residual else None
    return x, gamma, beta, w, bias, res


@pytest.mark.parametrize("shape,o,dtype,residual", [
    ((2, 16, 24, 64), 128, torch.bfloat16, False),
    ((1, 32, 32, 128), 64, torch.bfloat16, True),    # O < 128: a masked N tile
    ((2, 8, 40, 96), 136, torch.bfloat16, True),     # ragged M and N tiles
    ((1, 1, 1, 32), 8, torch.bfloat16, False),       # one pixel: every neighbour is padding
    ((2, 9, 21, 32), 256, torch.bfloat16, True),     # ragged both ways, C = 32, N tile 256
    ((1, 20, 12, 32), 72, torch.bfloat16, False),    # C = 32, O not a multiple of 128
    ((2, 32, 32, 512), 512, torch.bfloat16, True),   # the smallest main-path shape at bs 2
    ((2, 12, 20, 64), 32, torch.float32, False),
    ((1, 9, 7, 32), 12, torch.float32, True),
    ((2, 32, 32, 512), 512, torch.float32, True),   # the float32 engine's shape, + residual
    ((1, 9, 21, 96), 72, torch.float32, True),      # O off the 64-channel N tile
    ((2, 17, 33, 160), 132, torch.float32, False),  # ragged pixel tiles both ways
])
def test_fused_gn_conv_kernel_matches_plain(gen, shape, o, dtype, residual):
    args = _gn_conv_case(gen, shape, o, dtype, residual)
    before = fgc.fused_gn_swish_conv_cuda.launches
    got = fgc.fused_gn_swish_conv_cuda(*args)
    assert fgc.fused_gn_swish_conv_cuda.launches == before + 1
    _close(got, fgc.fused_gn_swish_conv_plain(*args),
           BF16_RTOL if dtype == torch.bfloat16 else FUSED_F32_TOL)
    assert torch.equal(fgc.fused_gn_swish_conv(*args), got)


def test_fused_gn_conv_kernel_refuses_grad_and_unsupported_widths(gen):
    x, gamma, beta, w, bias, _ = _gn_conv_case(gen, (1, 8, 8, 64), 64, torch.bfloat16, False)
    with pytest.raises(RuntimeError):
        fgc.fused_gn_swish_conv_cuda(x, gamma, beta, w.requires_grad_(), bias)
    x, gamma, beta, w, bias, _ = _gn_conv_case(gen, (1, 8, 8, 48), 64, torch.bfloat16, False)
    with pytest.raises(ValueError):  # C not a multiple of 32 in bf16
        fgc.fused_gn_swish_conv_cuda(x, gamma, beta, w, bias)


@pytest.mark.parametrize("shape,o", [
    ((2, 16, 16, 64), 128),
    ((1, 20, 12, 136), 72),   # C > 128 and O < 128: masked tiles on both edges
    ((2, 33, 17, 8), 8),
    ((16, 32, 32, 512), 512),
    ((1, 1, 7, 72), 136),     # one pixel row
    ((2, 9, 21, 136), 72),    # tiles of 2 x 32 ragged in H and W
    ((2, 32, 32, 512), 512),  # the smallest main-path shape at bs 2
])
def test_conv3x3_wgrad_kernel_matches_plain(gen, shape, o):
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(shape[:3] + (o,), generator=gen, device="cuda").to(torch.bfloat16)
    before = c3.conv3x3_wgrad_cuda.launches
    dw = c3.conv3x3_wgrad_cuda(x, g)
    assert c3.conv3x3_wgrad_cuda.launches == before + 1
    assert dw.shape == (3, 3, shape[-1], o) and dw.dtype == torch.float32
    _close_rel(dw, c3.conv3x3_wgrad_plain(x, g), WGRAD_REL)
    assert torch.equal(dw, c3.conv3x3_wgrad_cuda(x, g))


def test_conv3x3_autograd_runs_the_wgrad_kernel(gen):
    x = torch.randn((2, 16, 16, 64), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((3, 3, 64, 128), generator=gen, device="cuda") / 24
    bias = torch.randn((128,), generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
    before = c3.conv3x3_wgrad_cuda.launches
    y = c3.conv3x3_same_wg(*leaves)
    gy = torch.randn(y.shape, generator=gen, device="cuda")
    (y.float() * gy).sum().backward()
    assert c3.conv3x3_wgrad_cuda.launches == before + 1
    assert leaves[1].grad.dtype == torch.float32 and leaves[2].grad.dtype == torch.float32
    ref = [x.float().requires_grad_(), w.to(torch.bfloat16).float().requires_grad_(),
           bias.to(torch.bfloat16).float().requires_grad_()]
    y32 = torch.nn.functional.conv2d(ref[0].permute(0, 3, 1, 2), ref[1].permute(3, 2, 0, 1),
                                     ref[2], padding=1).permute(0, 2, 3, 1)
    (y32 * gy).sum().backward()
    for got, want in zip(leaves, ref):
        _close_rel(got.grad, want.grad, 2e-2)


GN_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}  # dx: summation order only


def _gn_case(gen, shape, dtype):
    c = shape[-1]
    x = (2 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    gamma = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
    beta = 0.2 * torch.randn((c,), generator=gen, device="cuda")
    _, (mean_c, rstd_c) = gsb.gn_swish_ref(x, gamma, beta)
    return x, dy, mean_c, rstd_c, gamma, beta


@pytest.mark.parametrize("shape,dtype", [
    ((2, 16, 16, 64), torch.bfloat16),
    ((1, 7, 9, 256), torch.float32),      # rows not a multiple of the band
    ((3, 32, 32, 512), torch.bfloat16),
    ((2, 4, 4, 2048), torch.float32),     # one row slot a block
    ((16, 64, 64, 128), torch.bfloat16),
    # the sd3unet ae step's four sites: slices of 32 and 128 channels, two
    # units a wave, three samples a wave
    ((16, 256, 256, 128), torch.bfloat16),
    ((16, 128, 128, 256), torch.bfloat16),
    ((16, 64, 64, 512), torch.bfloat16),
    ((16, 32, 32, 512), torch.bfloat16),
    ((16, 128, 128, 256), torch.float32),
])
def test_gn_swish_bwd_kernel_matches_plain(gen, shape, dtype):
    c = shape[-1]
    x, dy, mean_c, rstd_c, gamma, beta = _gn_case(gen, shape, dtype)
    before = gsb.gn_swish_bwd_cuda.launches
    got = gsb.gn_swish_bwd_cuda(x, dy, mean_c, rstd_c, gamma, beta)
    assert gsb.gn_swish_bwd_cuda.launches == before + 1
    want = gsb.gn_swish_bwd_plain(x, dy, mean_c, rstd_c, gamma, beta)
    _close(got[0], want[0], GN_BWD_TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and g.shape == (c,)
        _close_rel(g, w, 1e-4)
    again = gsb.gn_swish_bwd_cuda(x, dy, mean_c, rstd_c, gamma, beta)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape,dtype", [
    ((136, 4, 4, 64), torch.bfloat16),   # more samples than SMs: two waves, a block a sample
    ((140, 3, 5, 128), torch.float32),
])
def test_gn_swish_bwd_kernel_takes_several_waves(gen, shape, dtype):
    """A batch larger than the card's SMs runs in waves (one barrier each):
    against the plain version, bit-reproducible."""
    args = _gn_case(gen, shape, dtype)
    assert gsb.gn_bwd_plan(shape[0], shape[1] * shape[2], shape[3], 32, dtype).waves == 2
    got = gsb.gn_swish_bwd_cuda(*args)
    want = gsb.gn_swish_bwd_plain(*args)
    _close(got[0], want[0], GN_BWD_TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        _close_rel(g, w, 1e-4)
    again = gsb.gn_swish_bwd_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _kernels_of_one_call(fn):
    """Names of the CUDA kernels one call of fn runs (after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.key for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            for _ in range(ev.count)]


def test_norm_bwd_kernels_are_one_launch_a_call(gen):
    """The GroupNorm + swish backward and both LayerNorm backward entries
    are one cooperative kernel a call: no fill, no second pass, no reduce."""
    args = _gn_case(gen, (2, 32, 32, 256), torch.bfloat16)
    x, _, w, dy = _ln_bwd_case(gen, 4096, 768, torch.bfloat16)
    ds_in = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    for fn, kernel in ((lambda: gsb.gn_swish_bwd_cuda(*args), "gn_swish_bwd_kernel"),
                       (lambda: ln.layer_norm_bwd_cuda(x, w, dy), "ln_bwd_kernel"),
                       (lambda: ln.layer_norm_add_bwd_cuda(x, w, dy, ds_in), "ln_bwd_kernel")):
        names = _kernels_of_one_call(fn)
        assert len(names) == 1 and kernel in names[0], names


def test_norm_bwd_kernels_keep_their_barriers_apart_on_two_streams(gen):
    """Calls queued back to back on two streams at once (each stream's grid
    barrier counters its own) give the bits of the same calls made one by
    one."""
    gn_args = _gn_case(gen, (16, 32, 32, 512), torch.bfloat16)
    x, _, w, dy = _ln_bwd_case(gen, 16384, 768, torch.bfloat16)
    ds_in = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    calls = (lambda: gsb.gn_swish_bwd_cuda(*gn_args),
             lambda: ln.layer_norm_add_bwd_cuda(x, w, dy, ds_in),
             lambda: ln.layer_norm_bwd_cuda(x, w, dy))
    want = [fn() for fn in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                got.append([fn() for fn in calls])
    torch.cuda.synchronize()
    for outs in got:
        for a, b in zip(outs, want):
            assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_gn_swish_autograd_runs_the_bwd_kernel(gen):
    x = torch.randn((2, 16, 16, 128), generator=gen, device="cuda").to(torch.bfloat16)
    gamma = (1 + 0.3 * torch.randn((128,), generator=gen, device="cuda")).requires_grad_()
    beta = (0.2 * torch.randn((128,), generator=gen, device="cuda")).requires_grad_()
    xl = x.clone().requires_grad_()
    before = gsb.gn_swish_bwd_cuda.launches
    y = gsb.gn_swish(xl, gamma, beta)
    dy = torch.randn(y.shape, generator=gen, device="cuda")
    (y.float() * dy).sum().backward()
    assert gsb.gn_swish_bwd_cuda.launches == before + 1
    ref = [x.float().requires_grad_(), gamma.detach().clone().requires_grad_(),
           beta.detach().clone().requires_grad_()]
    (gsb.gn_swish_ref(*ref)[0] * dy).sum().backward()
    for got, want in zip((xl, gamma, beta), ref):
        _close_rel(got.grad, want.grad, 2e-2)


# the head-major op (ops/flash_attention_lean.py): the smoke's first four
# shapes, then a single query row and a single key, then the same and a
# ragged 200 x 328 on the wgmma forward at D = 64, then the wide backward's
# ragged cases at D = 256 and 512 (a single key, a single query row, partial
# tiles both ways) and the smoke's two shapes that fill the card
HEAD_MAJOR = [(2, 4, 512, 512, 64), (8, 12, 1024, 1024, 64), (1, 12, 8192, 8192, 64),
              (2, 2, 200, 328, 256), (2, 2, 1, 300, 128), (2, 2, 77, 1, 512),
              (2, 2, 1, 300, 64), (2, 2, 77, 1, 64), (2, 2, 200, 328, 64),
              (2, 2, 77, 1, 256), (1, 2, 1, 300, 256), (1, 2, 1, 300, 512),
              (2, 2, 200, 328, 512), (1, 2, 45, 100, 512), (4, 2, 1024, 1024, 256),
              (2, 1, 1024, 1024, 512)]


def _head_major(gen, b, h, lq, lk, d):
    q, do = (torch.randn((b, h, lq, d), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, h, lk, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("b,h,lq,lk,d", HEAD_MAJOR)
def test_head_major_kernels_match_plain(gen, b, h, lq, lk, d):
    q, k, v, do = _head_major(gen, b, h, lq, lk, d)
    scale = d ** -0.5
    # D = 64 and 128 run the wgmma backward body, D = 256 and 512 the wide one
    assert fa.flash_bwd_plan("head_major", b, h, lq, lk, d).body == \
        ("wgmma" if d in (64, 128) else "wgmma_wide")
    before = (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches)
    o, z = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
    o_p, z_p = fl.flash_attention_res_plain(q, k, v, scale)
    assert o.shape == q.shape and z.shape == (b, h, lq) and z.dtype == torch.float32
    assert float((o.float() - o_p.float()).abs().max()) <= FLASH_ATOL
    assert float((z - z_p).abs().max()) <= 1e-3 * max(1.0, float(z_p.abs().max()))
    assert torch.equal(o, fl.flash_attention_fwd_cuda(q, k, v, scale))
    got = fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)
    assert (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches) == \
        (before[0] + 2, before[1] + 1)
    want = fl.flash_attention_bwd_plain(q, k, v, o, z, do, scale)
    for g, w, t in zip(got, want, (q, k, v)):  # dq, dk, dv
        assert g.shape == t.shape and g.dtype == torch.bfloat16
        if lk == 1 and t is not v:
            # one key: p = 1 and ds = 0 in exact arithmetic, so dq and dk are
            # rounding noise with no relative error; hold them to dv's scale
            assert float(g.float().abs().max()) <= 1e-4 * float(want[2].float().abs().max())
        else:
            assert _rel_max(g, w) <= FLASH_BWD_REL
    del want
    again = fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("layout", ["packed", "token_major", "head_major"])
def test_flash_training_and_inference_forms_give_equal_o(gen, layout, d):
    """The forward with z and the one without are one kernel: o is
    bit-equal, on either body (D = 64, 128: wgmma; 256: wgmma_wide), ragged
    lengths included."""
    h, scale = 2, d ** -0.5
    if layout == "packed":
        qkv = torch.randn((2, 192, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        o, _ = fa.flash_attention_qkv_res_cuda(qkv, scale, h)
        assert torch.equal(o, fa.flash_attention_qkv_cuda(qkv, scale, h))
    elif layout == "token_major":
        q, k, v = (torch.randn((2, 192, h * d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o, _ = fa.flash_attention_res_cuda(q, k, v, scale, h)
        assert torch.equal(o, fa.flash_attention_cuda(q, k, v, scale, h))
    else:
        q, k, v, _ = _head_major(gen, 2, h, 200, 328, d)
        o, _ = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
        assert torch.equal(o, fl.flash_attention_fwd_cuda(q, k, v, scale))


def _misaligned(shape, gen):
    """A contiguous bf16 CUDA tensor whose data starts 2 bytes past a
    16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.randn((n + 1,), generator=gen, device="cuda").to(torch.bfloat16)
    t = buf[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 2
    return t


def test_flash_forward_kernels_refuse_misaligned_views(gen):
    """TMA and 16-byte loads need 16-byte aligned bases: a misaligned view
    raises ValueError in every forward wrapper, before any launch."""
    counters = (fa.flash_attention_qkv_cuda, fa.flash_attention_qkv_res_cuda,
                fa.flash_attention_cuda, fa.flash_attention_res_cuda, fl.flash_attention_fwd_cuda)
    before = [f.launches for f in counters]
    qkv = _misaligned((1, 128, 3 * 128), gen)
    for fn in (fa.flash_attention_qkv_cuda, fa.flash_attention_qkv_res_cuda):
        with pytest.raises(ValueError, match="aligned"):
            fn(qkv, 0.125, 2)
    good = torch.zeros((1, 128, 128), dtype=torch.bfloat16, device="cuda")
    bad = _misaligned((1, 128, 128), gen)
    for args in ((bad, good, good), (good, good, bad)):
        for fn in (fa.flash_attention_cuda, fa.flash_attention_res_cuda):
            with pytest.raises(ValueError, match="aligned"):
                fn(*args, 0.125, 2)
    hm_bad = _misaligned((1, 2, 128, 64), gen)
    hm_good = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        fl.flash_attention_fwd_cuda(hm_good, hm_bad, hm_good, 0.125)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 3, 333, 457, 64), (2, 2, 77, 200, 128),
                                         (1, 3, 333, 457, 256), (2, 2, 77, 200, 512),
                                         (1, 2, 45, 100, 512)])
def test_head_major_bwd_kernel_is_bit_reproducible(gen, b, h, lq, lk, d):
    """The wgmma backward bodies at ragged lengths (a partial last q tile in
    the dK/dV kernel, a partial last key tile in the dQ kernel, a warpgroup
    or block past the length; at D = 512 a cluster of two blocks whose
    partial scores meet): two more runs give equal bits, and the result is
    the plain version's within the bar."""
    q, k, v, do = _head_major(gen, b, h, lq, lk, d)
    scale = d ** -0.5
    o, z = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
    first = fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)
    for _ in range(2):
        assert all(torch.equal(x, y) for x, y in
                   zip(first, fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)))
    for g, w in zip(first, fl.flash_attention_bwd_plain(q, k, v, o, z, do, scale)):
        assert _rel_max(g, w) <= FLASH_BWD_REL


def _odd_layout(shape, kind, gen, dtype=torch.bfloat16):
    """A CUDA tensor of `shape` that no kernel reads as it lies: a view 2
    bytes past a 16-byte boundary ("misaligned", bf16 only) or the transpose
    of a tensor with its last two dims swapped ("transposed")."""
    if kind == "misaligned":
        return _misaligned(shape, gen)
    swapped = (*shape[:-2], shape[-1], shape[-2])
    t = torch.randn(swapped, generator=gen, device="cuda").to(dtype).transpose(-1, -2)
    assert not t.is_contiguous()
    return t


def _fresh(t):
    out = t.detach().clone(memory_format=torch.contiguous_format)
    assert out.is_contiguous() and out.data_ptr() % 16 == 0
    return out


@pytest.mark.parametrize("kind", ["misaligned", "transposed"])
@pytest.mark.parametrize("op", ["head_major", "head_major_grad", "sdpa_token_major",
                                "flash_attention_qkv", "layer_norm", "layer_norm_add"])
def test_public_ops_take_any_operand_layout(gen, op, kind):
    """Each public op on an operand the kernels cannot read as it lies (data
    off 16 bytes, or not contiguous) gives the same bits as on a fresh copy,
    and its kernel runs (its launch counter moves by one a call)."""
    w = torch.rand(256, generator=gen, device="cuda") + 0.5
    bias = torch.randn(256, generator=gen, device="cuda")
    blocks = fl.BlockSizes.get_default(1, 2, 128, 128, 64)
    if op in ("head_major", "head_major_grad"):
        args = [_odd_layout((1, 2, 128, 64), kind, gen) for _ in range(4)]  # q, k, v, do
        counters = [fl.flash_attention_fwd_cuda] + \
            ([fl.flash_attention_bwd_cuda] if op == "head_major_grad" else [])

        def run(q, k, v, do):
            if op == "head_major":
                return [fl.flash_attention(q, k, v, 0.125, blocks)]
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fl.flash_attention(*leaves, 0.125, blocks)
            o.backward(do)
            return [o.detach()] + [t.grad for t in leaves]
    elif op == "sdpa_token_major":
        args = [_odd_layout((1, 128, 2, 64), kind, gen) for _ in range(3)]
        counters, run = [fa.flash_attention_cuda], lambda q, k, v: [fa.sdpa_token_major(q, k, v)]
    elif op == "flash_attention_qkv":
        args = [_odd_layout((1, 128, 3 * 128), kind, gen)]
        counters, run = [fa.flash_attention_qkv_cuda], \
            lambda qkv: [fa.flash_attention_qkv(qkv, 0.125, 2)]
    elif op == "layer_norm":
        args = [_odd_layout((40, 256), kind, gen)]
        counters, run = [ln.layer_norm_cuda], lambda x: [ln.layer_norm(x, w, bias)]
    else:
        args = [_odd_layout((40, 256), kind, gen) for _ in range(2)]
        counters = [ln.layer_norm_add_cuda]
        run = lambda x, d: list(ln.layer_norm_add(x, d, w, bias))  # noqa: E731
    before = [f.launches for f in counters]
    got = run(*args)
    assert [f.launches for f in counters] == [n + 1 for n in before]
    want = run(*map(_fresh, args))
    assert all(torch.equal(g, t) for g, t in zip(got, want))


def test_head_major_autograd_runs_the_kernels(gen):
    q, k, v, do = _head_major(gen, 2, 2, 200, 328, 256)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    blocks = fl.BlockSizes(block_q=128, block_k_major=328, block_k=328, block_b=1,
                           block_q_major_dkv=200, block_k_major_dkv=328, block_k_dkv=328,
                           block_q_dkv=200, block_k_major_dq=328, block_k_dq=328,
                           block_q_dq=200)
    before = (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches)
    fl.flash_attention(*leaves, 256 ** -0.5, blocks).backward(do)
    assert (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    p = torch.softmax(ref[0] @ ref[1].transpose(-1, -2) * 256 ** -0.5, dim=-1)
    (p @ ref[2]).backward(do.float())
    for got, want in zip(leaves, ref):
        assert _rel_max(got.grad, want.grad) <= FLASH_BWD_REL


# the float32 op: the smoke's first four shapes, then ragged ones on the
# split-TF32 bodies at D = 64 and 128 (partial q and key tiles in every
# kernel, a single query row, Lq != Lk both ways), then on their wide form
# at D = 256 and 512 (two- and four-block clusters): partial q and key
# tiles with Lq < Lk and Lq > Lk, a single key, a single query row
HEAD_MAJOR_F32 = HEAD_MAJOR[:4] + [(2, 2, 200, 328, 64), (1, 3, 333, 457, 64),
                                   (2, 2, 77, 200, 128), (2, 2, 1, 300, 128),
                                   (1, 2, 300, 77, 64), (2, 2, 77, 200, 256),
                                   (1, 2, 300, 1, 256), (2, 1, 1, 300, 512),
                                   (2, 2, 77, 1, 512), (1, 2, 45, 100, 512),
                                   (1, 2, 300, 77, 512)]


@pytest.mark.parametrize("b,h,lq,lk,d", HEAD_MAJOR_F32)
def test_head_major_float32_kernels_match_plain(gen, b, h, lq, lk, d):
    """The float32 kernels (split TF32 on the tensor cores; at D = 256 and
    512 a block a share of D's columns, a cluster the row tile): o, z and
    dq, dk, dv within 1e-4 of the plain versions' largest value, the
    backward bit-equal across runs."""
    assert fa.flash_f32_plan(b, h, lq, lk, d).body == \
        ("split_tf32" if d in (64, 128) else "split_tf32_wide")
    q, k, v, do = (t.float() for t in _head_major(gen, b, h, lq, lk, d))
    scale = d ** -0.5
    o, z = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
    o_p, z_p = fl.flash_attention_res_plain(q, k, v, scale)
    assert o.dtype == torch.float32 and _rel_max(o, o_p) <= 1e-4 and _rel_max(z, z_p) <= 1e-4
    got = fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)
    want = fl.flash_attention_bwd_plain(q, k, v, o_p, z_p, do, scale)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32
        if lk == 1 and t is not v:
            # one key: p = 1 and ds = 0 in exact arithmetic, so dq and dk are
            # rounding noise with no relative error; hold them to dv's scale
            assert float(g.abs().max()) <= 1e-4 * float(want[2].abs().max())
        else:
            assert _rel_max(g, w) <= 1e-4
    del want
    assert all(torch.equal(x, y) for x, y in
               zip(got, fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)))


@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 3, 333, 457, 64), (2, 2, 77, 200, 128),
                                         (2, 2, 77, 200, 256), (1, 2, 45, 100, 512)])
def test_head_major_float32_bwd_kernel_is_bit_reproducible(gen, b, h, lq, lk, d):
    """The split-TF32 backward at ragged lengths (partial last q tiles in
    the dK/dV kernel and key tiles in the dQ kernel, a warpgroup past the
    length; at D = 256 and 512 partial scores summed over a cluster): three
    runs give equal bits, whatever the TF32 flags say (the kernels read
    none of them), and the forward's bits do not move with them either."""
    q, k, v, do = (t.float() for t in _head_major(gen, b, h, lq, lk, d))
    scale = d ** -0.5
    o, z = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
    first = fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        o2, z2 = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
        runs = [fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    runs.append(fl.flash_attention_bwd_cuda(q, k, v, o, z, do, scale))
    assert torch.equal(o, o2) and torch.equal(z, z2)
    for again in runs:
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_head_major_kernels_take_float32(gen):
    """A float32 training call runs one forward and one backward kernel
    launch and matches autograd of float32 attention."""
    q, k, v, do = (t.float() for t in _head_major(gen, 1, 2, 200, 328, 128))
    blocks = fl.BlockSizes(block_q=128, block_k_major=328, block_k=328, block_b=1,
                           block_q_major_dkv=200, block_k_major_dkv=328, block_k_dkv=328,
                           block_q_dkv=200, block_k_major_dq=328, block_k_dq=328,
                           block_q_dq=200)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches)
    fl.flash_attention(*leaves, 128 ** -0.5, blocks).backward(do)
    assert (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    p = torch.softmax(ref[0] @ ref[1].transpose(-1, -2) * 128 ** -0.5, dim=-1)
    (p @ ref[2]).backward(do)
    for got, want in zip(leaves, ref):
        assert _rel_max(got.grad, want.grad) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_major_backward_runs_first_on_autograds_thread(gen, dtype):
    """In a fresh process the training call's backward (float32: the
    split-TF32 bodies; bf16: the wgmma body) is the first CUDA work on
    autograd's backward thread, whose CUDA context no runtime call has
    bound yet: it runs, as every TMA entry's map encoder binds the
    thread's context (ROADMAP queue C, C4)."""
    import os
    import subprocess
    import sys

    code = "\n".join([
        "import torch",
        "from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl",
        f"q, k, v = (torch.randn((1, 2, n, 128), device='cuda', dtype=torch.{dtype},",
        "                       requires_grad=True) for n in (200, 328, 328))",
        "blocks = fl.BlockSizes(block_q=128, block_k_major=328, block_k=328, block_b=1,",
        "    block_q_major_dkv=200, block_k_major_dkv=328, block_k_dkv=328, block_q_dkv=200,",
        "    block_k_major_dq=328, block_k_dq=328, block_q_dq=200)",
        "o = fl.flash_attention(q, k, v, 128 ** -0.5, blocks)",
        "o.backward(torch.randn_like(o))",
        "torch.cuda.synchronize()",
        "assert fl.flash_attention_bwd_cuda.launches == 1",
        "assert all(bool(t.grad.isfinite().all()) for t in (q, k, v))"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_head_major_kernels_refuse_other_head_dims_and_dtypes(gen):
    """A head dim off 64/128/256/512, or float16, raises and runs nothing."""
    before = (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches)
    blocks = fl.BlockSizes.get_default(1, 1, 128, 128, 64)
    for dtype, d in ((torch.float32, 96), (torch.bfloat16, 96), (torch.float16, 64)):
        q = torch.zeros((1, 1, 128, d), dtype=dtype, device="cuda")
        with pytest.raises(ValueError):
            fl.flash_attention(q, q, q, 0.125, blocks)
        with pytest.raises(ValueError):
            fl.flash_attention(q.requires_grad_(), q, q, 0.125, blocks)
    assert (fl.flash_attention_fwd_cuda.launches, fl.flash_attention_bwd_cuda.launches) == before


def test_flash_bwd_kernels_take_d256(gen):
    """The unpacked and packed backward entries at D = 256 (32-row tiles)."""
    q, k, v, do = (torch.randn((2, 128, 2 * 256), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = 256 ** -0.5
    o, z = fa.flash_attention_res_cuda(q, k, v, scale, 2)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, z, do, scale, 2)
    want = fa.flash_attention_bwd_plain(q, k, v, o, z, do, scale, 2)
    for g, w in zip(got, want):
        assert _rel_max(g, w) <= FLASH_BWD_REL
    qkv = torch.cat([q, k, v], dim=-1)
    o, z = fa.flash_attention_qkv_res_cuda(qkv, scale, 2)
    got = fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, scale, 2)
    want = fa.flash_attention_qkv_bwd_plain(qkv, o, z, do, scale, 2)
    for g, w in zip(got.chunk(3, dim=-1), want.chunk(3, dim=-1)):
        assert _rel_max(g, w) <= FLASH_BWD_REL
    assert torch.equal(got, fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, scale, 2))


# the flash labs' kernels (ops/flash_lab.py) against their plain versions,
# at a small lab shape (B=2, L=256, H=12, D=64: L = 256 leaves the 192-row
# tilings a ragged last block) and at a ragged L = 200 (TMA's zero fill
# past L, the last key tile masked)
LAB_LENGTHS = (256, 200)


def _lab_inputs(gen, n, l=256):
    return [torch.randn((2, l, 12 * 64), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(n)]


@pytest.mark.parametrize("l", LAB_LENGTHS)
@pytest.mark.parametrize("variant,depth", fx.VARIANT_COMBOS)
def test_flash_variant_kernels_match_plain(gen, variant, depth, l):
    q, k, v = _lab_inputs(gen, 3, l)
    before = fx.flash_variant_cuda.launches
    got = fx.flash_variant_cuda(q, k, v, variant, depth, 0.125, 12)
    assert fx.flash_variant_cuda.launches == before + 1 and got.shape == q.shape
    if variant != "matonly":  # no softmax: a row sum of raw scores, ill-conditioned
        want = fx.flash_variant_plain(q, k, v, variant, 0.125, 12)
        assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL
    else:
        assert bool(torch.isfinite(got.float()).all())


@pytest.mark.parametrize("l", LAB_LENGTHS)
@pytest.mark.parametrize("hpb,rows,keys", fx.FWD_TILINGS)
def test_flash_fwd_tiling_kernels_match_plain(gen, hpb, rows, keys, l):
    q, k, v = _lab_inputs(gen, 3, l)
    got = fx.flash_fwd_tiling_cuda(q, k, v, hpb, rows, keys, 0.125, 12)
    want = fx.flash_variant_plain(q, k, v, "base", 0.125, 12)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL


@pytest.mark.parametrize("l", LAB_LENGTHS)
@pytest.mark.parametrize("rows,tile,stages", fx.BWD_TILINGS)
def test_flash_bwd_tiling_kernels_match_plain(gen, rows, tile, stages, l):
    q, k, v, do = _lab_inputs(gen, 4, l)
    o, z = fa.flash_attention_res_plain(q, k, v, 0.125, 12)
    o, z = o.contiguous(), z.contiguous()
    got = fx.flash_bwd_tiling_cuda(q, k, v, o, z, do, rows, tile, stages, 0.125, 12)
    want = fa.flash_attention_bwd_plain(q, k, v, o, z, do, 0.125, 12)
    for g, w in zip(got, want):
        assert _rel_max(g, w) <= FLASH_BWD_REL
    again = fx.flash_bwd_tiling_cuda(q, k, v, o, z, do, rows, tile, stages, 0.125, 12)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("l", LAB_LENGTHS)
@pytest.mark.parametrize("rows,tile,stages", fx.BWD_CONTROLS)
def test_flash_bwd_control_kernels_match_plain(gen, rows, tile, stages, l):
    q, k, v, do = _lab_inputs(gen, 4, l)
    got = fx.flash_bwd_control_cuda(q, k, v, do, rows, tile, stages, 12)
    want = fx.flash_bwd_control_plain(q, k, v, do, 12)
    for g, w in zip(got, want):
        assert _rel_max(g, w) <= FLASH_BWD_REL


def test_flash_lab_kernels_refuse_uncompiled_combos(gen):
    q, k, v = _lab_inputs(gen, 3)
    before = fx.flash_fwd_tiling_cuda.launches
    with pytest.raises(ValueError, match="compiled ones are"):
        fx.flash_fwd_tiling_cuda(q, k, v, 4, 128, 128, 0.125, 12)
    with pytest.raises(ValueError, match="compiled ones are"):
        fx.flash_variant_cuda(q, k, v, "chunk", 2, 0.125, 12)
    assert fx.flash_fwd_tiling_cuda.launches == before


# the LN-prologue matmul lab's kernels (ops/ln_matmul.py) against their plain
# versions: the lab's shapes and row blocks, and ragged ones (R off the
# 128-row tile, N off the 256-column tile, C below 768 and off the 64-channel
# K step, a last raster group with fewer M tiles, fewer tiles than SMs)
LN_MM_SHAPES = [(16384, 768, 2304, 128), (16384, 768, 3072, 512), (16384, 768, 2304, 1024),
                (1000, 768, 200, 256), (300, 256, 136, 128), (777, 96, 264, 384),
                (130, 32, 8, 128), (5000, 480, 776, 640)]


def _ln_mm_inputs(gen, r, c, n):
    x = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
    g, b = (torch.randn(c, generator=gen, device="cuda") for _ in range(2))
    w = (torch.randn((c, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    wb = torch.randn(n, generator=gen, device="cuda") * 0.01
    return x, g, b, w, wb


@pytest.mark.parametrize("r,c,n,bm", LN_MM_SHAPES)
def test_ln_matmul_kernels_match_plain(gen, r, c, n, bm):
    x, g, b, w, wb = _ln_mm_inputs(gen, r, c, n)
    before = lmm.ln_matmul_cuda.launches
    got = lmm.ln_matmul_cuda(x, g, b, w, wb, bm)
    assert lmm.ln_matmul_cuda.launches == before + 1 and got.shape == (r, n)
    want = lmm.ln_matmul_plain(x, g, b, w, wb)
    assert _rel_max(got, want) <= BF16_RTOL


@pytest.mark.parametrize("r,c,n,bm", LN_MM_SHAPES)
def test_matmul_bias_kernels_match_plain(gen, r, c, n, bm):
    x, _, _, w, wb = _ln_mm_inputs(gen, r, c, n)
    before = lmm.matmul_bias_cuda.launches
    got = lmm.matmul_bias_cuda(x, w, wb, bm)
    assert lmm.matmul_bias_cuda.launches == before + 1 and got.shape == (r, n)
    assert _rel_max(got, lmm.matmul_bias_plain(x, w, wb)) <= BF16_RTOL


@pytest.mark.parametrize("r,c,n,bm", [(16384, 768, 2304, 512), (777, 96, 264, 384)])
def test_ln_matmul_kernels_are_bit_reproducible(gen, r, c, n, bm):
    """No split-K and no atomics: both kernels repeat bit for bit."""
    x, g, b, w, wb = _ln_mm_inputs(gen, r, c, n)
    assert torch.equal(lmm.ln_matmul_cuda(x, g, b, w, wb, bm),
                       lmm.ln_matmul_cuda(x, g, b, w, wb, bm))
    assert torch.equal(lmm.matmul_bias_cuda(x, w, wb, bm), lmm.matmul_bias_cuda(x, w, wb, bm))


def test_ln_matmul_kernels_refuse_uncompiled_tilings_and_shapes(gen):
    x, g, b, w, wb = _ln_mm_inputs(gen, 256, 768, 256)
    before = (lmm.ln_matmul_cuda.launches, lmm.matmul_bias_cuda.launches)
    with pytest.raises(ValueError, match="not compiled"):
        lmm.ln_matmul_cuda(x, g, b, w, wb, 64)
    with pytest.raises(ValueError, match="not compiled"):
        lmm.matmul_bias_cuda(x, w, wb, 192)
    x2, g2, b2, w2, wb2 = _ln_mm_inputs(gen, 256, 800, 256)  # C past a row in a warp's registers
    with pytest.raises(ValueError, match="unsupported"):
        lmm.ln_matmul_cuda(x2, g2, b2, w2, wb2, 128)
    with pytest.raises(ValueError, match="unsupported"):
        lmm.matmul_bias_cuda(x, w[:, :12].contiguous(), wb[:12].contiguous(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        lmm.matmul_bias_cuda(x, w[:, :128], wb[:128].contiguous(), 128)
    assert (lmm.ln_matmul_cuda.launches, lmm.matmul_bias_cuda.launches) == before


def test_shipped_kernels_keep_their_registers(gen):
    """ptxas gives every kernel of the recorded table the registers it had
    (``tests/torch_kernel_registers.json``, written by ``python -m
    vqvae_from_gaussian_vae_tpu_torch.ops._build``): a new source must not
    move the register choice, and with it the occupancy, of a shipped
    kernel."""
    import json
    import os

    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    _build.library()
    with open(os.path.join(_build.build_dir(), "nvcc.log")) as f:
        got = _build.kernel_registers(f.read())
    with open(os.path.join(os.path.dirname(__file__), "torch_kernel_registers.json")) as f:
        want = json.load(f)
    assert {k: got.get(k) for k in want} == want
