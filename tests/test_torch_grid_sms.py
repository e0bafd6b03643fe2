"""The persistent-grid plans sized by the card's SM count.

The GroupNorm + swish backward (``ops/gn_swish_bwd.py:gn_bwd_plan``) and
the LayerNorm backward (``ops/layer_norm.py:ln_bwd_plan``) are one
cooperative launch each, whose blocks must all be resident; their wrappers
pass the device's SM count (``ops/grid_sync.py:device_sms``).  At the
shapes the shipped flows give them (the sd3unet ae step's GroupNorm sites
at bs 16, the bsqvit ae step's 16 x 1024 rows of 768), a plan for an H100
PCIe's 114 SMs asks for no more blocks than 114 SMs hold, and the plans for
an H100 SXM's 132 SMs are the ones the kernels ran before the SM count was
read from the card.
"""

import dataclasses

import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu_torch.ops import gn_swish_bwd as gsb
from vqvae_from_gaussian_vae_tpu_torch.ops import grid_sync
from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln

BATCH = 16
# (side, C): the sd3unet ae step's GroupNorm + swish sites at 256^2
GN_SITES = [(256, 128), (128, 256), (64, 512), (32, 512)]
LN_ROWS, LN_C = BATCH * 1024, 768  # bsqvit_gq_0.25: 1024 tokens of 768
# the plans at 132 SMs as the kernels ran them: (grid, threads, rows, cpu,
# upw, waves, smem) and (grid, threads, rows, stages, smem)
GN_AT_132 = {256: (128, 512, 8192, 8, 16, 1, 149312), 128: (128, 512, 2048, 8, 16, 1, 167232),
             64: (128, 512, 512, 8, 16, 1, 170304), 32: (128, 512, 128, 8, 16, 1, 170304)}
LN_AT_132 = {False: (132, 512, 16, 4, 199904), True: (132, 512, 16, 3, 224472)}


def _resident(plan, sms):
    return plan.grid <= sms * grid_sync.blocks_per_sm(plan.smem, plan.threads)


@pytest.mark.parametrize("side,c", GN_SITES)
@pytest.mark.parametrize("sms", [114, 132])
def test_gn_bwd_plan_fits_the_card(side, c, sms):
    plan = gsb.gn_bwd_plan(BATCH, side * side, c, 32, torch.bfloat16, sms)
    assert _resident(plan, sms) and plan.grid == plan.upw * plan.cpu
    assert plan.rows * plan.cpu >= side * side > plan.rows * (plan.cpu - 1)  # every row once
    if sms == 132:
        assert dataclasses.astuple(plan) == GN_AT_132[side]
        assert plan == gsb.gn_bwd_plan(BATCH, side * side, c, 32, torch.bfloat16)


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("sms", [114, 132])
def test_ln_bwd_plan_fits_the_card(add, sms):
    plan = ln.ln_bwd_plan(LN_ROWS, LN_C, torch.bfloat16, add=add, sms=sms)
    assert _resident(plan, sms) and plan.grid == sms
    if sms == 132:
        assert dataclasses.astuple(plan) == LN_AT_132[add]
        assert plan == ln.ln_bwd_plan(LN_ROWS, LN_C, torch.bfloat16, add=add)


def test_device_sms_is_read_once_a_device(monkeypatch):
    """The wrappers' SM count comes from the device's properties, read once
    and kept (no card here: a stand-in device query)."""
    calls = []

    class Props:
        multi_processor_count = 114

    def props(index):
        calls.append(index)
        return Props()

    monkeypatch.setattr(grid_sync, "_DEVICE_SMS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    assert grid_sync.device_sms("cuda:0") == 114
    assert grid_sync.device_sms(torch.device("cuda", 0)) == 114
    assert calls == [0]
