#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``vqvae_from_gaussian_vae_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py             # what a check of the port runs
    python3 chip_smoke.py --profile   # adds a torch.profiler breakdown of each step

It builds the hand-written CUDA kernels from ``csrc/``, holds each one
against its plain PyTorch version at the shapes the main paths give it,
then drives each path through the entry points a user calls, at bs=16,
256x256, with seeded random weights, and checks what comes out:

  * first, serving (``serve``): the port's daemon (``serve.py``) on
    sd3unet_gq_0.25 in bf16 at 127.0.0.1, whose worker thread makes the
    process's first kernel launches; 16 concurrent clients send rounds of
    /tokenize, /detokenize and /reconstruct with 256x256 PNGs, a cold load
    then a warm one: zero 5xx replies, a live worker, the launches exactly
    those of the drained buckets; a padded bucket against solo requests
    in bf16 and in float32 (each reply its own latent's code); requests a
    second, p50 and p99 a route, the bare engine's img/s at bs = 8;
  * tokenization (encode -> 2^16 GQ search -> dequant, bf16) of
    sd3unet_gq_0.25 (the UNet) and bsqvit_gq_0.25 (the ViT);
  * the two-phase GAN training pair of bsqvit_gq_0.25 and of
    sd3unet_gq_0.25, each with the bf16 overlay
    (``configs/overlays/bf16_compute.yaml``: bf16 compute, float32
    parameters and optimizer state), full width and depth: ae steps and
    disc steps with exact kernel launch counts, an eval step, and one ae
    step's gradient held against a float32 engine's;
  * the UNet's default-off kernels: sd3unet_gq_0.25 tokenization with
    ``fused_gn_conv: true`` (the fused GroupNorm + swish + conv), and its
    GAN pair with ``fused_gn_conv: true``, ``GVQ_CONV_WGRAD=1`` and
    ``GVQ_GN_BWD=1`` (the resblock conv's wgrad and the GroupNorm + swish
    backward), set here around that pair only.  It refuses to start when
    one of the kernel variables is already set;
  * the regularizers (``regularizers``): the eight other sd3unet configs,
    VQ, FSQ, LFQ, BSQ, GQ2, the two Gaussian ones and vf (its frozen
    DINOv2 ViT-L at full size), each with the bf16 overlay at full width
    and depth: a counted ae + disc pair with exact launches, two timed
    pairs and an eval step, parameters that move, encode -> dequant
    against decode, VQ's and GQ2's indices against the plain search, for
    VQ and vf one ae step's bf16 gradient against a float32 engine's and
    two steps of the training entry point;
  * the training entry point (``python -m vqvae_from_gaussian_vae_tpu_torch.main``,
    driven in-process through its ``main(argv)``) on a temporary folder
    of seeded JPEG and PNG images: sd3unet_gq_0.25 with the bf16 overlay at
    full width and depth for 4 steps (a validation, the image logger, the
    checkpoints), then ``--resume`` for 2 more, every restored tensor held
    to the checkpoint's; bsqvit_gq_0.25 with the overlay at 2 layers for 4
    steps; each ae, disc and eval step's kernel launches held to the
    training pair's;
  * data parallel (``ddp``): the same entry point under ``torchrun
    --nproc_per_node 2`` on a fresh folder of those images, sd3unet with
    the overlay at full width and depth, 8 images a rank, 4 steps (NCCL
    with a card a rank; on one card gloo, both ranks on card 0): every
    rank's launches a step held to the training pair's, the ranks' state
    bit-equal after the steps (digests), the first ae step's all-reduced
    gradient held to one process's on the joined batch, the all-reduce's
    bytes and ms a step;
  * the evaluation sweep (``eval_sweep``, ``python -m
    vqvae_from_gaussian_vae_tpu_torch.eval``): sd3unet full size at
    ``--dtype bfloat16``, bs 16 a rank, seeded Inception and LPIPS weight
    files, once on one rank in this process and once under torchrun on
    two, each image in the same batch at the same position in both: the
    codebook indices equal (or float64-proven near-ties), the metric means
    within 1e-4 (FID 1e-3), every batch's launches the inference step's;
  * the head-major flash attention (``ops/flash_attention_lean.py``), an
    op no model calls: one training call (forward with residuals, then the
    backward) at B=1, H=12, L=8192, D=64, in bf16 and in float32 (split
    TF32 on the tensor cores);
  * the flash labs (``labs/``: softmax policies and depth of the forward,
    its tilings, the backward's tilings and no-softmax control, each on the
    shipped ``wgmma`` body at its knobs), every default combo at (16, 1024,
    12, 64) bf16 through the labs' own ``run``, each checked output held to
    the einsum reference and to its plain version (``matonly`` is timed
    only);
  * the LayerNorm-prologue matmul lab (``labs/exp_ln_matmul.py``): every
    default combo (the LN kernel + cuBLAS pair, the LN kernel + the hand
    matmul, the fused kernel at row blocks 128 to 1024) at (16384, 768) @
    (768, 2304 and 3072) bf16 through the lab's own ``run``, each output
    held to the JAX lab's reference and to its plain version;
  * the post engine (``post``): sd3unet_gq_0.25's autoencoder with the
    bf16 dotlist and HDiT at its defaults in bf16 (its bottleneck's global
    attention on the flash kernels at (16, 1024, 4x64), whose entries the
    kernel phase also holds to their plain versions), ``patch_out`` and
    every ``attn_out`` seeded nonzero (their zero init cuts the attention
    off the velocity): a 50-step ``post`` call with its 200 flash launches,
    held to the same call on the einsum path, two train steps with exact
    launches, and the bf16 poster's gradient against a float32 poster's;
  * FLUX (``flux``): flux-dev at full width (11.9 B parameters, hidden
    3072, 24 heads of 128, 19 + 38 blocks) built on the card in bf16 with
    seeded weights, the JAX init's zero layers reseeded (zero, they make the
    velocity 0): one forward at bs 1, 256x256, 512 zero text tokens with
    its 57 launches of the flash forward at (1, 768, 24x128), whose entry
    the kernel phase also holds to its plain version, held to the same
    forward on the einsum path, and each of its 57 attention calls held to
    the einsum on that call's own inputs at the flash entry's bar; ms a
    forward, its profile, peak memory; one forward with rank-128 LoRA deltas;
  * the token decoder (``flux_dequant``): ``AutoencodingFluxEngine`` on
    sd3unet_gq_0.25's bf16 tokenizer with the full pipeline (flux-dev, its
    depth-2 ControlNet, the FLUX VAE): 2 steps of ``dequant`` held to the
    einsum path, then one timed 25-step ``dequant`` (2615 flash launches
    at flux's shape, the negative pass only under CFG, and the decoder's 3);
  * the baseline VAEs (``baselines``): FLUX, SD3, EQ, HunyuanImage-2 and -3,
    Qwen-Image and WAN (the WAN video VAE on one-frame clips) at their
    published widths in float32 through the port's ``eval.py`` in protocol
    mode over 12 seeded 256x256 images at bs 4 (PSNR, SSIM, LPIPS, img/s,
    peak memory);
  * the WAN video VAE (``wan_clip``) at the Qwen-Image widths in float32:
    the chunked streaming encode and decode of a seeded 9-frame 256x256
    clip (latent (1, 3, 32, 32, 16), the clip finite in [-1, 1], the first
    chunk equal to the whole-clip path on frame 0 within 1e-4);
  * the video sweep (``video_eval``): the port's ``eval.py --video --fvd
    --num_frames 9 --bs 2`` on sd3unet_gq_0.25 in bf16 over 4 seeded GIF
    clips with seeded Inception, LPIPS and I3D weights: each batch of 18
    frames with exactly the inference step's launches, finite PSNR, SSIM,
    LPIPS, FID and FVD, I3D's ms a clip; the VGG LPIPS on the card against
    the CPU within 1e-4;
  * the training entry point's ``--profile`` (``profile``): bsqvit at 2
    layers for 2 steps, its Chrome trace holding the flash kernels' CUDA
    events;
  * the kernel gates, read as the JAX package reads them: an sd3unet encode
    -> dequant at 200x200 (its 25x25 AttnBlocks take the einsum path), a
    2-layer bsqvit with ``GVQ_DISABLE_FUSED_KERNELS=1`` (no LayerNorm or
    flash kernel), and a reduced-depth sd3unet ae step with
    ``GVQ_DOWNSAMPLE_BWD=conv`` and ``GVQ_UPSAMPLE_BWD=conv`` (no resample
    dgrad or wgrad kernel), each held to the default path, and sd3unet
    with ``attn_type: linear`` at full width (no flash kernel), held to a
    float32 engine.

Every phase prints one JSON line; the ``seconds`` line gives each group of
phases its wall seconds.  The line before the last is the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result line.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet); a card set to a lower power limit runs below them.
PEAK_BF16 = 989e12      # tensor cores, FLOP/s
PEAK_FP32 = 67e12       # CUDA cores, FLOP/s
PEAK_TF32 = 495e12      # tensor cores, TF32, FLOP/s
PEAK_HBM = 3.35e12      # bytes/s

BATCH = 16
RES = 256
SEED = 0

# tolerances, each with its reason
BF16_RTOL = 1e-2   # kernel vs plain differ only in fp32 summation order; after
BF16_ATOL = 1e-2   # bf16 rounding that is at most one bf16 ulp (2^-7 relative)
STATS_RTOL = 1e-5  # the stats epilogue vs a float64 reduce of the stored output
FLASH_ATOL = 2e-2  # bf16 attention bar of the JAX package's flash tests
NEAR_TIE = 1e-5    # relative float64 score gap under which two GQ codes tie
Z_ATOL = 1e-3      # the log-normaliser: float32 sums in another order
FLASH_BWD_REL = 2e-2  # max error over max |grad|: the JAX package's flash bar
FLASH_F32_REL = 1e-4  # float32 flash kernels vs plain, TF32 off: float32 sums in another
#                       order, over the largest value
LN_BWD_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}  # dx: summation order only
LN_F32_REL = 1e-4  # the float32 LN forward vs plain: float32 sums in another order, over max |y|
PARAM_GRAD_REL = 1e-4  # dweight, dbias: float32 sums over 16384 rows in another order
TRAIN_GRAD_REL_L2 = 0.1  # one ae step's bf16 gradient vs a float32 engine's
TRAIN_GRAD_TENSOR_REL_L2 = 0.2  # the same, each tensor alone (worst measured: 7-11%)
# a gradient that is zero in exact arithmetic (attention's k bias: softmax is
# shift-invariant) has no relative error; it is one whose float32 norm is
# under this share of the whole gradient's, and is reported, not held
ZERO_GRAD_REL = 1e-6
WGRAD_REL = 1e-3  # float32 sums of exact bf16 products in another order, over max |dw|
FUSED_F32_TOL = 1e-4  # the fused GN conv's float32 variant: float32 sums in another order
PATH_SWITCH_REL_L2 = 2e-2  # one bf16 engine, kernels on against kernels off: bf16 rounds
#                           at other places (flash's unnormalised p, the einsum's normalised p)
# the kernel switches: the smoke sets each around the phase that reads it
KERNEL_ENV = ("GVQ_DISABLE_FUSED_KERNELS", "GVQ_FUSED_TRAIN", "GVQ_CONV_WGRAD", "GVQ_GN_BWD",
              "GVQ_DOWNSAMPLE_BWD", "GVQ_UPSAMPLE_BWD")
# the head-major op's shapes (B, H, Lq, Lk, D): the JAX test's, the JAX op's
# motivating bsqvit training shape, a long L (the op flow's), a ragged
# Lq != Lk at D = 256, and one shape at D = 256 and at 512 that fills the
# card (the wide backward's blocks: 128 and 64 dK/dV, 128 and 64 dQ)
FLASH_LEAN_SHAPES = [(2, 4, 512, 512, 64), (8, 12, 1024, 1024, 64), (1, 12, 8192, 8192, 64),
                     (2, 2, 200, 328, 256), (4, 2, 1024, 1024, 256), (2, 1, 1024, 1024, 512)]
FLASH_LEAN_FLOW = FLASH_LEAN_SHAPES[2]

# sd3unet_gq_0.25's resblock 3x3 convs (H = W, C -> O) and how many run at
# each per step: 24 resblocks, conv1 and conv2 each (the fused GN conv per
# inference step, the conv wgrad per ae step)
UNET_CONVS = [(256, 128, 128, 9), (256, 256, 128, 1), (128, 128, 256, 1), (128, 256, 256, 8),
              (128, 512, 256, 1), (64, 256, 512, 1), (64, 512, 512, 9), (32, 512, 512, 18)]
# its GroupNorm + swish sites (H = W, C) per ae step: 48 less the 6 that
# normalise from a fused resample's statistics
UNET_GN_SITES = [(256, 128, 9), (128, 256, 8), (64, 512, 8), (32, 512, 17)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call: ``labs/_timing.py``'s CUDA events around
    `iters` calls queued behind a device sleep, so that they time the
    device's work and not the host's."""
    from vqvae_from_gaussian_vae_tpu_torch.labs._timing import time_ms as timed

    return timed(fn, iters, warmup)


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    """(least time in ms, which of the two bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


@functools.lru_cache(maxsize=None)
def sass_hgmma() -> dict:
    """{kernel: count of HGMMA instructions} in the built library's SASS
    (``cuobjdump -sass``, one "Function : <name>" section per kernel)."""
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", os.path.join(_build.build_dir(), _build.LIB_NAME)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stdout[-2000:]}")
    counts, current = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            current = line.split("Function : ", 1)[1].strip()
            counts[current] = 0
        elif current is not None and "HGMMA" in line:
            counts[current] += 1
    return counts


def named_kernel_facts(source: str, *tags: str, spill_free: bool = False) -> dict:
    """The one kernel of `source` (a ``csrc`` file name) whose mangled name
    holds every one of `tags`: its symbol, ptxas's registers and spill bytes
    (stores + loads) from the build's ``nvcc.log`` (which must be 0 where
    `spill_free`) and the count of HGMMA (wgmma) instructions in its SASS
    (``cuobjdump``), which must not be 0."""
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    with open(os.path.join(_build.build_dir(), "nvcc.log")) as f:
        usage = _build.ptxas_usage(f.read())
    src = "_" + source.replace(".", "_") + "_"
    names = [n for n in usage if src in n and all(t in n for t in tags)]
    require(len(names) == 1, f"{len(names)} {' '.join(tags)} entries of {source} in nvcc.log")
    u = usage[names[0]]
    hgmma = sass_hgmma().get(names[0], 0)
    require(hgmma > 0, f"{names[0]}: no HGMMA in its SASS")
    spills = u.get("spill_stores", 0) + u.get("spill_loads", 0)
    require(not spill_free or spills == 0, f"{names[0]}: {spills} bytes of spills")
    return {"symbol": names[0], "registers": u["registers"], "spills": spills,
            "sass_hgmma": hgmma}


def ptxas_facts(source: str, *tags: str, spill_free: bool = True) -> dict:
    """The one kernel of `source` whose mangled name holds every one of
    `tags`: its symbol, and ptxas's registers and spill bytes (stores +
    loads), which must be 0 where `spill_free`."""
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    with open(os.path.join(_build.build_dir(), "nvcc.log")) as f:
        usage = _build.ptxas_usage(f.read())
    src = "_" + source.replace(".", "_") + "_"
    names = [n for n in usage if src in n and all(t in n for t in tags)]
    require(len(names) == 1, f"{len(names)} {' '.join(tags)} entries of {source} in nvcc.log")
    u = usage[names[0]]
    spills = u.get("spill_stores", 0) + u.get("spill_loads", 0)
    require(not spill_free or spills == 0, f"{names[0]}: {spills} bytes of spills")
    return {"symbol": names[0], "registers": u["registers"], "spills": spills}


def one_kernel_a_call(fn, kernel: str) -> dict:
    """The CUDA kernels three calls of fn run (torch.profiler), which must be
    the one kernel named `kernel`, at most once a call: its device ms and
    the launches recorded (the profiler may miss a launch of a long kernel,
    never add one; a profile that records none is taken again, up to three
    times)."""
    for _ in range(3):
        ran = device_kernel_ms(fn, iters=3)
        if ran:
            break
    require(len(ran) == 1 and kernel in next(iter(ran))
            and 1 <= next(iter(ran.values()))["launches"] <= 3,
            f"{kernel}: three calls ran {ran}, not one kernel at most once a call")
    only = next(iter(ran.values()))
    return {"kernels_a_call": 1, "launches_recorded_of_3": only["launches"],
            "kernel_alone_ms": only["ms"]}


def wgrad_kernel_facts(source: str, o: int) -> dict:
    """The weight-gradient body's kernel (``csrc/conv_wgrad.cuh``) that
    `source` launches for O output channels: its design and output-channel
    tile, and its registers, spills and HGMMA count (named_kernel_facts)."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.downsample_conv import wgrad_tile_o

    tile_o = wgrad_tile_o(o)
    return {**named_kernel_facts(source, "conv_wgrad_kernel", f"ELi{tile_o}EE"),
            "design": "wgmma", "tile_o": tile_o}


def igemm_kernel_facts(mode: str, b: int, h: int, w: int, c: int, o: int) -> dict:
    """The Hopper implicit-GEMM body's kernel (``csrc/conv_igemm_sm90.cuh``)
    that the downsample forward ("fwd", "fwd_add") or dgrad ("dgrad"), the
    upsample forward ("up_fwd", "up_fwd_add") or dgrad ("up_dgrad"), or the
    bf16 fused GroupNorm + swish conv ("same_gn") launches on x (b, h, w, c)
    and O output channels: its plan's spatial and channel tiles, and its
    registers, no spills and HGMMA count (named_kernel_facts)."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.downsample_conv import igemm_plan

    plan = igemm_plan(mode, b, h, w, c, o)
    source = {"dgrad": "downsample_bwd.cu", "up_dgrad": "upsample_bwd.cu",
              "up_fwd": "upsample_conv.cu", "up_fwd_add": "upsample_conv.cu",
              "same_gn": "fused_gn_conv.cu"}.get(mode, "downsample_conv.cu")
    ax = {"fwd_add": "4AAdd", "up_fwd_add": "4AAdd", "same_gn": "3AGn"}.get(mode, "9AIdentity")
    number = {"dgrad": 1, "up_dgrad": 2, "up_fwd": 3, "up_fwd_add": 3,
              "same_gn": 4}.get(mode, 0)  # the header's IgemmMode
    tag = f"conv_igemm_sm90_kernelILi{number}ELi{plan.tile_n}ENS0_{ax}E"
    return {**named_kernel_facts(source, tag, spill_free=True), "design": "wgmma",
            "tile": f"{plan.tile_h}x{plan.tile_w}", "tile_n": plan.tile_n,
            "stages": plan.stages, "blocks_per_sm": plan.blocks_per_sm}


def flash_fwd_kernel_facts(d: int, lq: int, lk: int) -> dict:
    """The bf16 flash forward kernel the entries launch at head dim d and
    lengths lq, lk: its design ("wgmma": ``csrc/flash_fwd_sm90.cuh``, D = 64
    and 128; "wgmma_wide": ``csrc/flash_fwd_sm90_wide.cuh``, D = 256 and
    512), its tiles, and its registers, no spills and HGMMA count
    (named_kernel_facts)."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import flash_fwd_plan

    plan = flash_fwd_plan("head_major", 1, 1, lq, lk, d)
    kernel = "flash_fwd_wide_kernel" if plan.body == "wgmma_wide" else "flash_fwd_sm90_kernel"
    tag = f"{kernel}ILi{d}ELb{int(plan.key_mask)}E"
    return {**named_kernel_facts("flash_fwd.cu", tag, spill_free=True),
            "design": plan.body, "q_rows": plan.q_rows, "k_rows": plan.k_rows,
            "stages": plan.stages}


def flash_bwd_kernel_facts(d: int, lq: int, lk: int) -> dict:
    """The bf16 flash backward's two kernels that the entries launch at head
    dim d and lengths lq, lk: the body ("wgmma": ``csrc/flash_bwd_sm90.cuh``,
    D = 64 and 128; "wgmma_wide": ``csrc/flash_bwd_sm90_wide.cuh``, D = 256
    and 512, whose blocks of a cluster split D `splits` ways), and for the
    dK/dV and the dQ kernel its symbol, registers, no spills and HGMMA count
    (named_kernel_facts)."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import flash_bwd_plan

    plan = flash_bwd_plan("head_major", 1, 1, lq, lk, d)
    body = {"wgmma": "sm90", "wgmma_wide": "wide"}[plan.body]
    tags = {"dkdv": f"flash_bwd_dkdv_{body}_kernelILi{d}ELb{int(plan.q_mask)}E",
            "dq": f"flash_bwd_dq_{body}_kernelILi{d}ELb{int(plan.key_mask)}E"}
    return {"design": plan.body, "kv_rows": plan.kv_rows, "kv_q_rows": plan.kv_q_rows,
            "q_rows": plan.q_rows, "q_k_rows": plan.q_k_rows, "splits": plan.splits,
            "kernels": {k: named_kernel_facts("flash_bwd.cu", tag, spill_free=True)
                        for k, tag in tags.items()}}


def flash_f32_kernel_facts(b: int, h: int, lq: int, lk: int, d: int) -> dict:
    """The float32 head-major op's kernels at (b, h, lq, lk, d), by
    ``flash_f32_plan``: the body
    ("split_tf32": ``csrc/flash_fwd_f32_sm90.cuh`` and
    ``csrc/flash_bwd_f32_sm90.cuh``, D = 64 and 128; "split_tf32_wide":
    ``csrc/flash_fwd_f32_sm90_wide.cuh`` and ``csrc/flash_bwd_f32_sm90_wide.cuh``,
    D = 256 and 512), each kernel's tiles, column share and cluster, and its
    registers, spills and HGMMA count (named_kernel_facts); and the
    pre-pass's scratch (forward and backward) in MiB."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import flash_f32_plan

    plan = flash_f32_plan(b, h, lq, lk, d)
    wide = plan.body == "split_tf32_wide"
    kernels = {}
    for kernel, source, t in (("fwd", "flash_fwd.cu", plan.fwd),
                              ("dkdv", "flash_bwd.cu", plan.dkdv),
                              ("dq", "flash_bwd.cu", plan.dq)):
        name = {"fwd": "flash_fwd_f32", "dkdv": "flash_bwd_dkdv_f32",
                "dq": "flash_bwd_dq_f32"}[kernel] + ("_wide_kernel" if wide else "_sm90_kernel")
        split = t.share if wide else t.rows // 64
        tag = f"{name}ILi{d}ELi{split}ELi{t.tile}ELi{t.stages}ELb{int(t.mask)}E"
        kernels[kernel] = {**named_kernel_facts(source, tag), "rows": t.rows, "tile": t.tile,
                           "stages": t.stages, "smem": t.smem, "share": t.share,
                           "cluster": t.cluster}
    return {"design": plan.body, "kernels": kernels,
            "scratch_mib": 4 * (plan.fwd_scratch + plan.bwd_scratch) / 2**20}


def f32_build_facts() -> dict:
    """Every split-TF32 float32 flash kernel the build made (both bodies,
    each with and without the key mask) and its pre-pass: ptxas's registers and spill
    bytes and the HGMMA count of its SASS, named as
    ``tests/torch_kernel_registers.json`` names kernels."""
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    with open(os.path.join(_build.build_dir(), "nvcc.log")) as f:
        usage = _build.ptxas_usage(f.read())
    return {_build._ANON.sub(r"<\1.cu>", n): {
        "registers": u["registers"], "spills": u.get("spill_stores", 0) + u.get("spill_loads", 0),
        "sass_hgmma": sass_hgmma().get(n, 0)}
        for n, u in sorted(usage.items())
        if "f32_sm90_kernel" in n or "f32_wide_kernel" in n or "tf_prep_kernel" in n}


def device_kernel_ms(fn, iters: int = 1) -> dict:
    """{CUDA kernel: {"ms": mean device ms a launch, "launches": launches
    recorded}} for each kernel that fn runs, from torch.profiler over
    `iters` calls after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key: {"ms": ev.self_device_time_total / 1e3 / ev.count, "launches": ev.count}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}


def device_kernels(fn) -> list:
    """Names of the CUDA kernels that one call of fn runs (torch.profiler)."""
    return sorted(device_kernel_ms(fn))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phases: each kernel against its plain version at main-path shapes


def near_tie_gap(got, want, mu, std, codebook, beta: float = 1.0) -> float:
    """Largest float64 score gap over rows where `got` != `want`; raises if
    any such row is not a near-tie.  At std 1 and beta 0 the score is minus
    half the squared L2 distance plus a constant: VQ's search."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import gq_scores_reference

    rows = (got != want).nonzero().flatten().tolist()
    worst = 0.0
    for r in rows:
        g, w = int(got[r]), int(want[r])
        s = gq_scores_reference(mu[r:r + 1].cpu().numpy(), std[r:r + 1].cpu().numpy(),
                                codebook[[g, w]].cpu().numpy(), beta)[0]
        gap = abs(float(s[0] - s[1]))
        require(gap <= NEAR_TIE * max(1.0, abs(float(s[1]))),
                f"GQ index {g} != {w} at row {r} is no near-tie (float64 gap {gap})")
        worst = max(worst, gap)
    return worst


def check_gq(gen):
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops import codebook as cb_ops
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_cuda import gq_argmax_cuda
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import argmax_blocked, score_operands
    from vqvae_from_gaussian_vae_tpu_torch.utils.flops import gq_search_flops

    rows, group, n = BATCH * 32 * 32, 16, 65536  # one index group per latent pixel
    cb = torch.from_numpy(cb_ops.prior_samples(n, group, 42).copy()).cuda()
    mu = torch.randn((rows, group), generator=gen, device="cuda")
    std = torch.exp(0.5 * torch.randn((rows, group), generator=gen, device="cuda").clamp(-4, 1))
    a, b = score_operands(mu, std, cb, 1.0)
    got = gq_argmax_cuda(a, b)
    want = argmax_blocked(a, b)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    gap = near_tie_gap(got, want, mu, std, cb)
    flops = gq_search_flops(rows, group, n)
    nbytes = a.numel() * 4 + b.numel() * 4 + rows * 4
    bnd, by = bound_ms(flops, nbytes, PEAK_FP32)
    shape = {"shape": f"A ({rows},{2 * group}) f32 x B ({2 * group},{n}) f32",
             "kernel_ms": time_ms(lambda: gq_argmax_cuda(a, b)),
             "plain_ms": time_ms(lambda: argmax_blocked(a, b)),
             # two named calls, float32 with TF32 off: the (rows, n) score
             # matrix (4.3 GB at the main path's shape) goes through memory
             "library_ms": time_ms(lambda: torch.argmax(a @ b, dim=1)),
             "library_bytes": nbytes + 2 * rows * n * 4 + rows * 8,
             "bound_ms": bnd, "bound_by": by,
             "flops": flops, "bytes": nbytes, "mismatches": mismatches,
             "max_abs_err": gap}
    return {"name": "gq_argmax", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/gq_argmax.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/gq_pallas.py:83",
            "tolerance": f"indices equal, or a float64 near-tie (relative {NEAR_TIE})",
            "per_step": 1, "path": "sd3unet", "shapes": [shape]}


def _within(got, want, atol, rtol):
    """(max abs error, max error over atol + rtol |want|)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / (atol + rtol * want.float().abs())).max())


def _bf16_err(got, want):
    return _within(got, want, BF16_ATOL, BF16_RTOL)


def _stats_err(y, stats) -> float:
    """Relative error of the (sum, sumsq) epilogue against a float64 reduce
    of the stored output, scaled by sum |y| and sum y^2."""
    import torch

    yd = y.double().flatten(1, 2)
    ref = torch.stack([yd.sum(1), (yd * yd).sum(1)], dim=1)
    scale = torch.stack([yd.abs().sum(1), (yd * yd).sum(1)], dim=1).clamp_min(1e-30)
    return float(((stats.double() - ref).abs() / scale).max())


def _conv_inputs(gen, shape, add):
    import torch

    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    a = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) if add else None
    wt = (torch.randn((3, 3, c, c), generator=gen, device="cuda") * (9 * c) ** -0.5).to(torch.bfloat16)
    bias = (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(torch.bfloat16)
    return x, a, wt, bias


def check_resample(gen, kind: str):
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
    from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up

    if kind == "down":
        cases = [((BATCH, 256, 256, 128), True), ((BATCH, 128, 128, 256), True),
                 ((BATCH, 64, 64, 512), True)]
        kernel, plain = down.downsample_conv3x3_gn_cuda, down.downsample_conv3x3_gn_plain
    else:
        cases = [((BATCH, 32, 32, 512), False), ((BATCH, 64, 64, 512), True),
                 ((BATCH, 128, 128, 256), True)]
        kernel, plain = up.upsample_nearest_conv3x3_gn_cuda, up.upsample_nearest_conv3x3_gn_plain
    shapes = []
    for shape, add in cases:
        b, h, w, c = shape
        x, a, wt, bias = _conv_inputs(gen, shape, add)
        y_k, s_k = kernel(x, wt, bias, a)
        y_k2, s_k2 = kernel(x, wt, bias, a)
        y_p, _ = plain(x, wt, bias, a)
        torch.cuda.synchronize()
        err, ratio = _bf16_err(y_k, y_p)
        require(ratio <= 1.0, f"{kind} {shape}: kernel vs plain error {err} beyond "
                              f"atol {BF16_ATOL} + rtol {BF16_RTOL}")
        s_err = _stats_err(y_k, s_k)
        require(s_err <= STATS_RTOL, f"{kind} {shape}: stats error {s_err}")
        # the Hopper body: y and the statistics repeat bit for bit
        require(torch.equal(y_k, y_k2) and torch.equal(s_k, s_k2),
                f"{kind} {shape}: two runs differ")
        mode = ("fwd" if kind == "down" else "up_fwd") + ("_add" if add else "")
        facts = {"bit_reproducible": True, **igemm_kernel_facts(mode, b, h, w, c, c)}
        del y_k2, s_k2
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC buffer: channels_last
        if kind == "down":
            ho, wo = h // 2, w // 2
            flops = 2.0 * b * ho * wo * 9 * c * c
            x_pad = F.pad(x_cl, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
            lib = time_ms(lambda: F.conv2d(x_pad, w_oihw, bias, stride=2))
            out_elems, w_elems = b * ho * wo * c, 9 * c * c
        else:
            flops = 2.0 * b * h * w * 16 * c * c
            lib = time_ms(lambda: F.conv2d(F.interpolate(x_cl, scale_factor=2.0, mode="nearest"),
                                           w_oihw, bias, padding=1))
            out_elems, w_elems = b * 4 * h * w * c, 9 * c * c
        nbytes = 2 * ((2 if add else 1) * x.numel() + w_elems + c + out_elems) + 4 * b * 2 * c
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
        ms = time_ms(lambda: kernel(x, wt, bias, a))
        shapes.append({
            "shape": f"x {tuple(shape)} bf16" + (" + add" if add else ""),
            "kernel_ms": ms, "tflops": flops / ms / 1e9,
            "plain_ms": time_ms(lambda: plain(x, wt, bias, a), iters=3, warmup=1),
            "library_ms": lib, "bound_ms": bnd, "bound_by": by, "flops": flops,
            "bytes": nbytes, "max_abs_err": err, "err_over_tol": ratio,
            "stats_rel_err": s_err, **facts})
        del x, a, y_k, y_p, s_k
        torch.cuda.empty_cache()
    if kind == "down":
        return {"name": "downsample_conv3x3_gn", "route": "cuda",
                "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/downsample_conv.cu",
                "replaces": "vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py:125",
                "tolerance": f"bf16 atol {BF16_ATOL} + rtol {BF16_RTOL}; stats rtol {STATS_RTOL}",
                "per_step": 3, "path": "sd3unet", "shapes": shapes}
    return {"name": "upsample_nearest_conv3x3_gn", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/upsample_conv.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py:199",
            "tolerance": f"bf16 atol {BF16_ATOL} + rtol {BF16_RTOL}; stats rtol {STATS_RTOL}",
            "per_step": 3, "path": "sd3unet", "shapes": shapes}


UNET_FLASH = (BATCH, 32 * 32, 1, 512)  # (B, L, heads, D): the UNet AttnBlock at 32x32


def _flash_body(d: int, direction: str) -> str:
    """The ``csrc`` body of the bf16 flash kernels at head dim d."""
    wide = "_wide" if d in (256, 512) else ""
    return f"vqvae_from_gaussian_vae_tpu_torch/csrc/flash_{direction}_sm90{wide}.cuh"


def check_flash(gen, dims=UNET_FLASH, name="flash_attention_fwd", path="sd3unet",
                per_step=5):
    """The unpacked token-major forward at `dims` against its plain version,
    SDPA's time on head-major copies beside it; `name`, `path` and
    `per_step` name the kernel line (another name counts the launches of
    ``flash_attention_fwd`` on that path)."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

    b, l, heads, d = dims
    q, k, v = (torch.randn((b, l, heads * d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    o_k = fa.flash_attention_cuda(q, k, v, scale, heads)
    o_p = fa.flash_attention_plain(q, k, v, scale, heads)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    require(err <= FLASH_ATOL, f"flash: kernel vs plain error {err} > {FLASH_ATOL}")
    qh, kh, vh = (t.view(b, l, heads, d).transpose(1, 2) for t in (q, k, v))
    flops = 4.0 * b * heads * l * l * d
    nbytes = 4 * q.numel() * 2
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
    kernel_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, scale, heads))
    shape = {"shape": f"q,k,v ({b},{l},{heads}x{d}) bf16",
             "kernel_ms": kernel_ms, "tflops": flops / kernel_ms / 1e9,
             "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, scale, heads)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)),
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": err, **flash_fwd_kernel_facts(d, l, l)}
    return {"name": name, "counters": ["flash_attention_fwd"], "route": "cuda",
            "source": _flash_body(d, "fwd"),
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_blc.py:319",
            "tolerance": f"bf16 atol {FLASH_ATOL}", "per_step": per_step, "path": path,
            "shapes": [shape]}


def check_flash_qkv(gen):
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

    b, l, heads, d = BATCH, 32 * 32, 12, 64  # the ViT's attention, width 768
    c = heads * d
    qkv = torch.randn((b, l, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    scale = d ** -0.5
    o_k = fa.flash_attention_qkv_cuda(qkv, scale, heads)
    o_p = fa.flash_attention_qkv_plain(qkv, scale, heads)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    require(err <= FLASH_ATOL, f"packed flash: kernel vs plain error {err} > {FLASH_ATOL}")
    # the library call reads head-major q, k, v made beforehand
    qh, kh, vh = (t.reshape(b, l, heads, d).transpose(1, 2).contiguous()
                  for t in qkv.chunk(3, dim=-1))
    flops = 4.0 * b * heads * l * l * d
    nbytes = 2 * (qkv.numel() + o_k.numel())
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
    kernel_ms = time_ms(lambda: fa.flash_attention_qkv_cuda(qkv, scale, heads))
    shape = {"shape": f"qkv ({b},{l},3x{heads}x{d}) bf16",
             "kernel_ms": kernel_ms, "tflops": flops / kernel_ms / 1e9,
             "plain_ms": time_ms(lambda: fa.flash_attention_qkv_plain(qkv, scale, heads),
                                 iters=3, warmup=1),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)),
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": err, **flash_fwd_kernel_facts(d, l, l)}
    return {"name": "flash_attention_qkv_fwd", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_fwd_sm90.cuh",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_blc.py:401",
            "tolerance": f"bf16 atol {FLASH_ATOL}", "per_step": 24, "path": "bsqvit",
            "shapes": [shape]}


def check_flash_qkv_res(gen):
    """The packed training forward: o and z against the plain version; its
    time beside the inference entry's (the z store must not slow the
    inference form)."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

    b, l, heads, d = BATCH, 32 * 32, 12, 64
    c = heads * d
    qkv = torch.randn((b, l, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    scale = d ** -0.5
    o_k, z_k = fa.flash_attention_qkv_res_cuda(qkv, scale, heads)
    o_p, z_p = fa.flash_attention_qkv_res_plain(qkv, scale, heads)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    z_err = float((z_k - z_p).abs().max())
    require(err <= FLASH_ATOL, f"packed flash (training form): o error {err} > {FLASH_ATOL}")
    require(z_err <= Z_ATOL, f"packed flash (training form): z error {z_err} > {Z_ATOL}")
    require(torch.equal(o_k, fa.flash_attention_qkv_cuda(qkv, scale, heads)),
            "packed flash: the training form's o differs from the inference form's")
    qh, kh, vh = (t.reshape(b, l, heads, d).transpose(1, 2).contiguous()
                  for t in qkv.chunk(3, dim=-1))
    flops = 4.0 * b * heads * l * l * d
    nbytes = 2 * (qkv.numel() + o_k.numel()) + 4 * z_k.numel()
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
    kernel_ms = time_ms(lambda: fa.flash_attention_qkv_res_cuda(qkv, scale, heads))
    shape = {"shape": f"qkv ({b},{l},3x{heads}x{d}) bf16 -> o, z (B,H,L) f32",
             "kernel_ms": kernel_ms, "tflops": flops / kernel_ms / 1e9,
             "inference_form_ms": time_ms(lambda: fa.flash_attention_qkv_cuda(qkv, scale, heads)),
             "plain_ms": time_ms(lambda: fa.flash_attention_qkv_res_plain(qkv, scale, heads),
                                 iters=3, warmup=1),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)),
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": max(err, z_err), "o_max_abs_err": err, "z_max_abs_err": z_err,
             **flash_fwd_kernel_facts(d, l, l)}
    return {"name": "flash_attention_qkv_res_fwd", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_fwd_sm90.cuh",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_blc.py:409",
            "tolerance": f"o bf16 atol {FLASH_ATOL}; z atol {Z_ATOL}", "per_step": 24,
            "path": "bsqvit_train_ae", "shapes": [shape]}


def check_flash_qkv_bwd(gen):
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

    b, l, heads, d = BATCH, 32 * 32, 12, 64
    c = heads * d
    qkv = torch.randn((b, l, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, l, c), generator=gen, device="cuda").to(torch.bfloat16)
    scale = d ** -0.5
    o, z = fa.flash_attention_qkv_res_cuda(qkv, scale, heads)
    got = fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, scale, heads)
    want = fa.flash_attention_qkv_bwd_plain(qkv, o, z, do, scale, heads)
    again = fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, scale, heads)
    torch.cuda.synchronize()
    require(torch.equal(got, again), "packed flash backward: two runs differ")
    errs = []
    for name, g, w in zip("qkv", got.chunk(3, dim=-1), want.chunk(3, dim=-1)):
        rel = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        require(rel <= FLASH_BWD_REL, f"packed flash backward: d{name} error {rel} of max |grad|")
        errs.append(rel)
    err = float((got.float() - want.float()).abs().max())
    del want
    # the library call: SDPA's backward on head-major tensors, forward outside
    qh, kh, vh = (t.reshape(b, l, heads, d).transpose(1, 2).contiguous().requires_grad_()
                  for t in qkv.chunk(3, dim=-1))
    oh = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    doh = do.reshape(b, l, heads, d).transpose(1, 2).contiguous()
    library = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)  # noqa: E731
    flops = 5 * 2.0 * b * heads * l * l * d
    nbytes = 2 * (2 * qkv.numel() + o.numel() + do.numel()) + 4 * z.numel()
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
    kernel_ms = time_ms(lambda: fa.flash_attention_qkv_bwd_cuda(qkv, o, z, do, scale, heads))
    shape = {"shape": f"qkv ({b},{l},3x{heads}x{d}), o, do bf16, z f32 -> dqkv bf16",
             "kernel_ms": kernel_ms, "tflops": flops / kernel_ms / 1e9,
             "plain_ms": time_ms(lambda: fa.flash_attention_qkv_bwd_plain(
                 qkv, o, z, do, scale, heads), iters=2, warmup=1),
             "library_ms": time_ms(library), "library": "SDPA backward (autograd), head-major",
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": err, "rel_err_dq_dk_dv": errs, "bit_reproducible": True,
             **flash_bwd_kernel_facts(d, l, l)}
    return {"name": "flash_attention_qkv_bwd", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_bwd_sm90.cuh",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_blc.py:444",
            "tolerance": f"max error / max |grad| <= {FLASH_BWD_REL} per dq, dk, dv; "
                         "bit-equal across runs",
            "per_step": 24, "path": "bsqvit_train_ae", "shapes": [shape]}


def check_resample_bwd(gen, kind: str):
    """The resample backward at the training step's shapes: dgrad and wgrad
    against their plain versions, the wgrad bit-equal across two runs; the
    library yardstick is cuDNN's convolution backward of the same conv, on
    the padded (downsample) or interpolated (upsample) input, each gradient
    alone (output_mask) and both in one call (no add, no statistics fold,
    and for the upsample dx of the high-resolution input)."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv as down
    from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv as up

    if kind == "down":
        cases = [(BATCH, 256, 256, 128), (BATCH, 128, 128, 256), (BATCH, 64, 64, 512)]
        dgrad_k, dgrad_p = down.downsample_dgrad_cuda, down.downsample_dgrad_plain
        wgrad_k, wgrad_p = down.downsample_wgrad_cuda, down.downsample_wgrad_plain
    else:
        cases = [(BATCH, 32, 32, 512), (BATCH, 64, 64, 512), (BATCH, 128, 128, 256)]
        dgrad_k, dgrad_p = up.upsample_dgrad_cuda, up.upsample_dgrad_plain
        wgrad_k, wgrad_p = up.upsample_wgrad_cuda, up.upsample_wgrad_plain
    src, jax_file = (("downsample_bwd.cu", "downsample_conv.py") if kind == "down"
                     else ("upsample_bwd.cu", "upsample_conv.py"))
    dshapes, wshapes = [], []
    for shape in cases:
        b, h, w, c = shape
        x, _, wt, _ = _conv_inputs(gen, shape, False)
        gshape = (b, h // 2, w // 2, c) if kind == "down" else (b, 2 * h, 2 * w, c)
        g = torch.randn(gshape, generator=gen, device="cuda").to(torch.bfloat16)
        wop = wt if kind == "down" else up.phase_kernels(wt)  # dgrad's weight operand
        dx_k, dx_k2, dx_p = dgrad_k(g, wop), dgrad_k(g, wop), dgrad_p(g, wop)
        dw_k, dw_k2, dw_p = wgrad_k(x, g), wgrad_k(x, g), wgrad_p(x, g)
        torch.cuda.synchronize()
        err, ratio = _bf16_err(dx_k, dx_p)
        require(ratio <= 1.0, f"{kind} dgrad {shape}: kernel vs plain error {err} beyond "
                              f"atol {BF16_ATOL} + rtol {BF16_RTOL}")
        # the Hopper body: dx repeats bit for bit
        require(torch.equal(dx_k, dx_k2), f"{kind} dgrad {shape}: two runs differ")
        d_facts = {"bit_reproducible": True,
                   **igemm_kernel_facts("dgrad" if kind == "down" else "up_dgrad", b, h, w, c, c)}
        del dx_k2
        require(torch.equal(dw_k, dw_k2), f"{kind} wgrad {shape}: two runs differ")
        w_err = float((dw_k - dw_p).abs().max())
        w_rel = w_err / float(dw_p.abs().max())
        require(w_rel <= WGRAD_REL, f"{kind} wgrad {shape}: error {w_rel} of max |dw|")
        del dx_p, dw_p, dw_k2
        # the library call: convolution_backward of the conv the op computes
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC buffer: channels_last
        g_cl = g.permute(0, 3, 1, 2)
        if kind == "down":
            x_in = F.pad(x_cl, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
            stride, pad = [2, 2], [0, 0]
            flops = 2.0 * b * (h // 2) * (w // 2) * 9 * c * c
            w_out = 9 * c * c
        else:
            x_in = F.interpolate(x_cl, scale_factor=2.0, mode="nearest")
            stride, pad = [1, 1], [1, 1]
            flops = 2.0 * b * h * w * 16 * c * c
            w_out = 16 * c * c  # dk22

        def library(mask):
            return lambda: torch.ops.aten.convolution_backward(
                g_cl, x_in, w_oihw, None, stride, pad, [1, 1], False, [0, 0], 1, mask)

        both_ms = time_ms(library([True, True, False]))
        d_bytes = 2 * (g.numel() + wop.numel() + x.numel())
        w_bytes = 2 * (x.numel() + g.numel()) + 4 * w_out
        label = f"x {tuple(shape)}, g {tuple(gshape)} bf16"
        for out, kern, plain, lib_mask, nbytes, e in (
                (dshapes, lambda: dgrad_k(g, wop), lambda: dgrad_p(g, wop),
                 [True, False, False], d_bytes,
                 {"max_abs_err": err, "err_over_tol": ratio, **d_facts}),
                (wshapes, lambda: wgrad_k(x, g), lambda: wgrad_p(x, g),
                 [False, True, False], w_bytes,
                 {"max_abs_err": w_err, "rel_err_of_max": w_rel, "bit_reproducible": True,
                  **wgrad_kernel_facts(src, c)})):
            bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
            ms = time_ms(kern)
            out.append({"shape": label, "kernel_ms": ms, "tflops": flops / ms / 1e9,
                        "plain_ms": time_ms(plain, iters=3, warmup=1),
                        "library_ms": time_ms(library(lib_mask)), "library_dx_dw_ms": both_ms,
                        "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes, **e})
        del x, g, x_in, dx_k, dw_k
        torch.cuda.empty_cache()
    op = "downsample" if kind == "down" else "upsample"
    lines = {"down": (496, 576), "up": (641, 732)}[kind]
    common = {"route": "cuda", "source": f"vqvae_from_gaussian_vae_tpu_torch/csrc/{src}",
              "per_step": 3, "path": "sd3unet_train_ae"}
    return [{"name": f"{op}_dgrad", **common,
             "replaces": f"vqvae_from_gaussian_vae_tpu/ops/{jax_file}:{lines[0]}",
             "tolerance": f"bf16 atol {BF16_ATOL} + rtol {BF16_RTOL}; bit-equal across runs",
             "shapes": dshapes},
            {"name": f"{op}_wgrad", **common,
             "replaces": f"vqvae_from_gaussian_vae_tpu/ops/{jax_file}:{lines[1]}",
             "tolerance": f"max error / max |dw| <= {WGRAD_REL}; bit-equal across runs",
             "shapes": wshapes}]


def check_flash_res(gen, dims=UNET_FLASH, name="flash_attention_res_fwd",
                    path="sd3unet_train_ae", per_step=5):
    """The unpacked training forward (the UNet AttnBlock's, or at `dims`):
    o and z against the plain version; its time beside the inference
    entry's."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

    b, l, heads, d = dims
    q, k, v = (torch.randn((b, l, heads * d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    o_k, z_k = fa.flash_attention_res_cuda(q, k, v, scale, heads)
    o_p, z_p = fa.flash_attention_res_plain(q, k, v, scale, heads)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    z_err = float((z_k - z_p).abs().max())
    require(err <= FLASH_ATOL, f"flash (training form): o error {err} > {FLASH_ATOL}")
    require(z_err <= Z_ATOL, f"flash (training form): z error {z_err} > {Z_ATOL}")
    require(torch.equal(o_k, fa.flash_attention_cuda(q, k, v, scale, heads)),
            "flash: the training form's o differs from the inference form's")
    qh, kh, vh = (t.view(b, l, heads, d).transpose(1, 2) for t in (q, k, v))
    flops = 4.0 * b * heads * l * l * d
    nbytes = 4 * q.numel() * 2 + 4 * z_k.numel()
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
    kernel_ms = time_ms(lambda: fa.flash_attention_res_cuda(q, k, v, scale, heads))
    shape = {"shape": f"q,k,v ({b},{l},{heads}x{d}) bf16 -> o, z (B,H,L) f32",
             "kernel_ms": kernel_ms, "tflops": flops / kernel_ms / 1e9,
             "inference_form_ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, scale, heads)),
             "plain_ms": time_ms(lambda: fa.flash_attention_res_plain(q, k, v, scale, heads)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)),
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": max(err, z_err), "o_max_abs_err": err, "z_max_abs_err": z_err,
             **flash_fwd_kernel_facts(d, l, l)}
    return {"name": name, "counters": ["flash_attention_res_fwd"], "route": "cuda",
            "source": _flash_body(d, "fwd"),
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_blc.py:387",
            "tolerance": f"o bf16 atol {FLASH_ATOL}; z atol {Z_ATOL}", "per_step": per_step,
            "path": path, "shapes": [shape]}


def check_flash_bwd(gen, dims=UNET_FLASH, name="flash_attention_bwd",
                    path="sd3unet_train_ae", per_step=5):
    """The unpacked backward at the UNet AttnBlock's shape (D = 512: the
    wide wgmma body, two blocks a cluster), or at `dims`: dq, dk, dv
    against the plain version, bit-equal across two runs; its kernels'
    symbols, registers, spills and HGMMA counts."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

    b, l, heads, d = dims
    q, k, v, do = (torch.randn((b, l, heads * d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, z = fa.flash_attention_res_cuda(q, k, v, scale, heads)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, z, do, scale, heads)
    want = fa.flash_attention_bwd_plain(q, k, v, o, z, do, scale, heads)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, z, do, scale, heads)
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(got, again)), "flash backward: two runs differ")
    errs = []
    for which, g, w in zip("qkv", got, want):
        rel = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        require(rel <= FLASH_BWD_REL, f"flash backward: d{which} error {rel} of max |grad|")
        errs.append(rel)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    del want, again
    qh, kh, vh = (t.view(b, l, heads, d).transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    oh = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    doh = do.view(b, l, heads, d).transpose(1, 2).contiguous()
    library = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)  # noqa: E731
    flops = 5 * 2.0 * b * heads * l * l * d
    nbytes = 2 * 8 * q.numel() + 4 * z.numel()  # q, k, v, o, do in; dq, dk, dv out
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
    kernel_ms = time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, o, z, do, scale, heads))
    shape = {"shape": f"q,k,v,o,do ({b},{l},{heads}x{d}) bf16, z f32 -> dq,dk,dv bf16",
             "kernel_ms": kernel_ms, "tflops": flops / kernel_ms / 1e9,
             "plain_ms": time_ms(lambda: fa.flash_attention_bwd_plain(
                 q, k, v, o, z, do, scale, heads), iters=3, warmup=1),
             "library_ms": time_ms(library), "library": "SDPA backward (autograd), head-major",
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": err, "rel_err_dq_dk_dv": errs, "bit_reproducible": True,
             **flash_bwd_kernel_facts(d, l, l)}
    return {"name": name, "counters": ["flash_attention_bwd"], "route": "cuda",
            "source": _flash_body(d, "bwd"),
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_blc.py:439",
            "tolerance": f"max error / max |grad| <= {FLASH_BWD_REL} per dq, dk, dv; "
                         "bit-equal across runs",
            "per_step": per_step, "path": path, "shapes": [shape]}


PCIE_SMS = 114  # an H100 PCIe's SMs: the persistent grids' plans must fit it too


def at_sms(sms: int, fn):
    """fn() with the persistent-grid wrappers sizing their plans for `sms`
    SMs (``ops/grid_sync.py:device_sms``), as on a card that has that many."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops import grid_sync

    index = torch.cuda.current_device()
    grid_sync.device_sms(index)
    saved = grid_sync._DEVICE_SMS[index]
    grid_sync._DEVICE_SMS[index] = sms
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        grid_sync._DEVICE_SMS[index] = saved


def _grid_at_114(got, want, tol) -> dict:
    """A plan sized for 114 SMs against the plain version, under the same
    bars as the card's own plan."""
    dx_err, ratio = _within(got[0], want[0], tol, tol)
    rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got[1:], want[1:]))
    return {"max_abs_err": dx_err, "err_over_tol": ratio, "param_grad_rel_err": rel}


def check_layer_norm_bwd(gen, add: bool):
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln
    from vqvae_from_gaussian_vae_tpu_torch.ops import grid_sync

    rows, c = BATCH * 32 * 32, 768
    shapes = []
    for dtype, main in ((torch.bfloat16, True), (torch.float32, False)):
        x = (2 * torch.randn((rows, c), generator=gen, device="cuda") + 0.5).to(dtype)
        dy = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
        ds_in = torch.randn((rows, c), generator=gen, device="cuda").to(dtype) if add else None
        w = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
        if add:
            kernel = lambda: ln.layer_norm_add_bwd_cuda(x, w, dy, ds_in)  # noqa: E731
        else:
            kernel = lambda: ln.layer_norm_bwd_cuda(x, w, dy)  # noqa: E731
        plain = lambda: ln.layer_norm_bwd_plain(x, w, dy, ds_in=ds_in)  # noqa: E731
        got, want, again = kernel(), plain(), kernel()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"LN{'-add' if add else ''} backward: two runs differ")
        tol = LN_BWD_TOL[str(dtype)]
        pcie = _grid_at_114(at_sms(PCIE_SMS, kernel), want, tol)
        require(pcie["err_over_tol"] <= 1.0 and pcie["param_grad_rel_err"] <= PARAM_GRAD_REL,
                f"LN{'-add' if add else ''} backward {dtype} on a {PCIE_SMS}-SM plan: {pcie}")
        pcie["plan"] = dataclasses.asdict(ln.ln_bwd_plan(rows, c, dtype, add=add, sms=PCIE_SMS))
        dx_err = float((got[0].float() - want[0].float()).abs().max())
        require(bool(((got[0].float() - want[0].float()).abs()
                      <= tol + tol * want[0].float().abs()).all()),
                f"LN{'-add' if add else ''} backward {dtype}: dx error {dx_err}")
        p_err = 0.0
        for g, wnt in zip(got[1:], want[1:]):
            rel = float((g - wnt).abs().max() / wnt.abs().max())
            require(rel <= PARAM_GRAD_REL, f"LN backward {dtype}: dweight/dbias error {rel}")
            p_err = max(p_err, rel)
        # the library call: autograd of F.layer_norm (after x + d for the add
        # variant), forward outside the timed region
        xl = x.detach().clone().requires_grad_()
        wl = w.to(dtype).clone().requires_grad_()  # a copy: w itself stays without grad
        bl = torch.zeros((c,), device="cuda", dtype=dtype, requires_grad=True)
        if add:
            dl = torch.zeros_like(x, requires_grad=True)
            yl = F.layer_norm(xl + dl, (c,), wl, bl, 1e-5)
            ins = (xl, dl, wl, bl)
        else:
            yl = F.layer_norm(xl, (c,), wl, bl, 1e-5)
            ins = (xl, wl, bl)
        library = lambda: torch.autograd.grad(yl, ins, dy, retain_graph=True)  # noqa: E731
        e = x.element_size()
        nbytes = e * (4 if add else 3) * x.numel() + 4 * 3 * c
        flops = 12.0 * x.numel()
        bnd, by = bound_ms(flops, nbytes, PEAK_FP32)
        plan = ln.ln_bwd_plan(rows, c, dtype, add=add, sms=grid_sync.device_sms(x.device))
        tname = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
        facts = {"plan": dataclasses.asdict(plan),
                 **ptxas_facts("layer_norm.cu", f"ln_bwd_kernelI{tname}Li"
                               f"{ln.nch_class(c, dtype)}ELb{int(add)}E"),
                 **one_kernel_a_call(kernel, "ln_bwd_kernel")}
        shapes.append({"shape": f"x ({rows},{c}) {str(dtype).split('.')[-1]}"
                                + (" + ds_in" if add else ""), "main_path": main,
                       "kernel_ms": time_ms(kernel), "plain_ms": time_ms(plain),
                       "library_ms": time_ms(library), **facts,
                       "library": ("autograd of x + d, then F.layer_norm" if add
                                   else "autograd of F.layer_norm"),
                       "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
                       "max_abs_err": dx_err, "param_grad_rel_err": p_err,
                       "bit_reproducible": True, f"at_{PCIE_SMS}_sms": pcie})
        del x, dy, ds_in, got, want, again, xl, yl
        torch.cuda.empty_cache()
    name = "layer_norm_add_bwd" if add else "layer_norm_bwd"
    return {"name": name, "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/layer_norm.cu",
            "replaces": ("vqvae_from_gaussian_vae_tpu/ops/layer_norm.py:209" if add
                         else "vqvae_from_gaussian_vae_tpu/ops/layer_norm.py:172"),
            "tolerance": "dx atol = rtol 1e-2 (bf16) / 1e-4 (f32); dweight, dbias "
                         f"max error / max |value| <= {PARAM_GRAD_REL}; bit-equal across runs",
            "per_step": 46 if add else 6, "path": "bsqvit_train_ae", "shapes": shapes}


def check_layer_norm(gen, add: bool):
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln

    rows, c = BATCH * 32 * 32, 768  # the ViT's (B*L, width) token rows
    x = (2 * torch.randn((rows, c), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    d = torch.randn((rows, c), generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    w16, b16 = w.to(torch.bfloat16), bias.to(torch.bfloat16)  # for the library call
    if add:
        s_k, y_k = ln.layer_norm_add_cuda(x, d, w, bias)
        s_p, y_p = ln.layer_norm_add_plain(x, d, w, bias)
        torch.cuda.synchronize()
        require(torch.equal(s_k, s_p), "LN-add: kernel's s differs from plain x + d")
        kernel = lambda: ln.layer_norm_add_cuda(x, d, w, bias)  # noqa: E731
        plain = lambda: ln.layer_norm_add_plain(x, d, w, bias)  # noqa: E731
        library = lambda: F.layer_norm(x + d, (c,), w16, b16, 1e-5)  # noqa: E731
        nbytes = 2 * 4 * x.numel() + 2 * 4 * c
        flops = 9.0 * x.numel()  # add; sum; centre, square, sum; normalise, scale, shift
    else:
        y_k = ln.layer_norm_cuda(x, w, bias)
        y_p = ln.layer_norm_plain(x, w, bias)
        torch.cuda.synchronize()
        kernel = lambda: ln.layer_norm_cuda(x, w, bias)  # noqa: E731
        plain = lambda: ln.layer_norm_plain(x, w, bias)  # noqa: E731
        library = lambda: F.layer_norm(x, (c,), w16, b16, 1e-5)  # noqa: E731
        nbytes = 2 * 2 * x.numel() + 2 * 4 * c
        flops = 8.0 * x.numel()
    err, ratio = _bf16_err(y_k, y_p)
    require(ratio <= 1.0, f"LN{'-add' if add else ''}: kernel vs plain error {err} beyond "
                          f"atol {BF16_ATOL} + rtol {BF16_RTOL}")
    bnd, by = bound_ms(flops, nbytes, PEAK_FP32)
    shape = {"shape": f"x ({rows},{c}) bf16" + (" + d" if add else ""),
             "kernel_ms": time_ms(kernel), "plain_ms": time_ms(plain),
             "library_ms": time_ms(library),
             "library": "x + d, then F.layer_norm (two calls)" if add else "F.layer_norm",
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": err, "err_over_tol": ratio}
    name = "layer_norm_add_fwd" if add else "layer_norm_fwd"
    return {"name": name, "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/layer_norm.cu",
            "replaces": ("vqvae_from_gaussian_vae_tpu/ops/layer_norm.py:192" if add
                         else "vqvae_from_gaussian_vae_tpu/ops/layer_norm.py:159"),
            "tolerance": f"bf16 atol {BF16_ATOL} + rtol {BF16_RTOL}"
                         + ("; s bit-equal" if add else ""),
            "per_step": 46 if add else 6, "path": "bsqvit", "shapes": [shape]}


def check_fused_gn_conv(gen):
    """The fused GroupNorm + swish + conv at every resblock conv shape of
    the sd3unet inference step (bf16), with a residual, and in float32 at a
    small shape and at the float32 engine's 32x32 512-channel conv (TF32
    off, as everywhere in the smoke).  Each row times the wrapper (``gn_affine``'s plain torch,
    then the kernel), the kernel alone on the affine made beforehand, and
    ``gn_affine`` alone; the output repeats bit for bit, and the facts
    (plan tiles, registers, no spills, HGMMA) are the Hopper bodies': the
    implicit-GEMM body in bf16, split TF32 in float32 (with its two
    kernels' device times, the weight pre-pass and the conv: two launches a
    counted call; its bound is split TF32's, three TF32 passes, with the
    CUDA cores' beside it).  Library: F.group_norm, F.silu, then cuDNN's conv, in the
    compute dtype (three calls)."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import fused_gn_conv as fgc

    cases = [(BATCH, h, c, o, n, torch.bfloat16, False) for h, c, o, n in UNET_CONVS]
    # float32: a small shape, and the 32x32 512-channel resblock conv of the
    # float32 engine the smoke holds the bf16 flows to (bs=2)
    cases += [(BATCH, 128, 512, 256, 0, torch.bfloat16, True),
              (2, 32, 64, 64, 0, torch.float32, False), (2, 32, 512, 512, 0, torch.float32, False)]
    shapes = []
    for b, h, c, o, n, dtype, residual in cases:
        x = (2 * torch.randn((b, h, h, c), generator=gen, device="cuda") + 0.3).to(dtype)
        gamma = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.3 * torch.randn((c,), generator=gen, device="cuda")
        w = torch.randn((3, 3, c, o), generator=gen, device="cuda") / (3 * c ** 0.5)
        bias = 0.1 * torch.randn((o,), generator=gen, device="cuda")
        res = torch.randn((b, h, h, o), generator=gen, device="cuda").to(dtype) if residual else None
        args = (x, gamma, beta, w, bias, res)
        y_k = fgc.fused_gn_swish_conv_cuda(*args)
        y_p = fgc.fused_gn_swish_conv_plain(*args)
        scale, shift = fgc.gn_affine(x, gamma, beta)
        y_a = fgc.fused_gn_swish_conv_affine_cuda(x, scale, shift, w, bias, res)
        torch.cuda.synchronize()
        tol = (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (FUSED_F32_TOL, FUSED_F32_TOL)
        err, ratio = _within(y_k, y_p, *tol)
        require(ratio <= 1.0, f"fused GN conv {(b, h, h, c, o)} {dtype}: error {err} beyond "
                              f"atol {tol[0]} + rtol {tol[1]}")
        # both Hopper bodies: y repeats bit for bit
        require(torch.equal(y_k, y_a), f"fused GN conv {(b, h, h, c, o)} {dtype}: two runs differ")
        if dtype == torch.bfloat16:
            facts = {"bit_reproducible": True, **igemm_kernel_facts("same_gn", b, h, h, c, o)}
        else:  # split TF32: the plan's tiles, and each of the call's two kernels alone
            plan = fgc.gn_conv_f32_plan(b, h, h, c, o)
            facts = named_kernel_facts("fused_gn_conv.cu", "gn_conv_split_tf32_kernel",
                                       spill_free=True)
            parts = device_kernel_ms(
                lambda: fgc.fused_gn_swish_conv_affine_cuda(x, scale, shift, w, bias, res), 10)
            facts = {"bit_reproducible": True, "design": "split_tf32", **facts,
                     "kernels_per_call": 2,  # the weight pre-pass, then the conv
                     "tile": "x".join(map(str, fgc.F32_TILE)), "tile_n": fgc.F32_TILE_N,
                     "stages": fgc.F32_STAGES, "blocks": plan.blocks,
                     "device_ms": {("weight_prep" if "weight_prep" in k else "conv"): v["ms"]
                                   for k, v in parts.items()}}
        del y_p, y_a
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC buffer: channels_last
        w_cl = w.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        g_d, b_d, bias_d = gamma.to(dtype), beta.to(dtype), bias.to(dtype)
        library = lambda: F.conv2d(F.silu(F.group_norm(x_cl, 32, g_d, b_d, 1e-6)),  # noqa: E731
                                   w_cl, bias_d, padding=1)
        e = x.element_size()
        flops = 2.0 * b * h * h * 9 * c * o
        nbytes = e * (x.numel() + y_k.numel() * (2 if residual else 1) + w.numel()) + 4 * (2 * c + o)
        if dtype == torch.bfloat16:
            bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
        else:  # the body's bound, three TF32 passes; the CUDA cores' beside it
            bnd, by = bound_ms(3 * flops, nbytes, PEAK_TF32)
            facts["cuda_core_bound_ms"] = bound_ms(flops, nbytes, PEAK_FP32)[0]
        kernel_alone = time_ms(
            lambda: fgc.fused_gn_swish_conv_affine_cuda(x, scale, shift, w, bias, res))
        shapes.append({"shape": f"x ({b},{h},{h},{c}) -> O {o} {str(dtype).split('.')[-1]}"
                                + (" + residual" if residual else ""),
                       "main_path": n > 0, "per_step": n,
                       "kernel_ms": time_ms(lambda: fgc.fused_gn_swish_conv_cuda(*args)),
                       "kernel_alone_ms": kernel_alone, "tflops_alone": flops / kernel_alone / 1e9,
                       "gn_affine_ms": time_ms(lambda: fgc.gn_affine(x, gamma, beta)),
                       "plain_ms": time_ms(lambda: fgc.fused_gn_swish_conv_plain(*args),
                                           iters=3, warmup=1),
                       "library_ms": time_ms(library), "bound_ms": bnd, "bound_by": by,
                       "flops": flops, "bytes": nbytes, "max_abs_err": err,
                       "err_over_tol": ratio, **facts})
        del x, res, y_k, args, scale, shift
        torch.cuda.empty_cache()
    return {"name": "fused_gn_swish_conv", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/fused_gn_conv.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/fused_gn_conv.py:141",
            "tolerance": f"bf16 atol {BF16_ATOL} + rtol {BF16_RTOL}; float32 atol "
                         f"{FUSED_F32_TOL} + rtol {FUSED_F32_TOL}",
            "kernel_alone_ms_per_step": sum(s["per_step"] * s["kernel_alone_ms"] for s in shapes),
            "gn_affine_ms_per_step": sum(s["per_step"] * s["gn_affine_ms"] for s in shapes),
            "per_step": 48, "path": "sd3unet_fused_gn_conv", "shapes": shapes}


def check_conv3x3_wgrad(gen):
    """The resblock conv's wgrad at every conv shape of the sd3unet ae step,
    bit-equal across two runs.  Library: cuDNN's convolution_backward, dw
    only."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops import conv3x3_train as c3

    shapes = []
    for h, c, o, n in UNET_CONVS:
        x = torch.randn((BATCH, h, h, c), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((BATCH, h, h, o), generator=gen, device="cuda").to(torch.bfloat16)
        dw_k, dw_k2, dw_p = c3.conv3x3_wgrad_cuda(x, g), c3.conv3x3_wgrad_cuda(x, g), \
            c3.conv3x3_wgrad_plain(x, g)
        torch.cuda.synchronize()
        require(torch.equal(dw_k, dw_k2), f"conv3x3 wgrad {(h, c, o)}: two runs differ")
        err = float((dw_k - dw_p).abs().max())
        rel = err / float(dw_p.abs().max())
        require(rel <= WGRAD_REL, f"conv3x3 wgrad {(h, c, o)}: error {rel} of max |dw|")
        del dw_k2, dw_p
        w_cl = (torch.randn((o, c, 3, 3), generator=gen, device="cuda") / (3 * c ** 0.5)).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        library = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            g_cl, x_cl, w_cl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])
        flops = 2.0 * BATCH * h * h * 9 * c * o
        nbytes = 2 * (x.numel() + g.numel()) + 4 * dw_k.numel()
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
        ms = time_ms(lambda: c3.conv3x3_wgrad_cuda(x, g))
        shapes.append({"shape": f"x ({BATCH},{h},{h},{c}), g O {o} bf16", "per_step": n,
                       "kernel_ms": ms, "tflops": flops / ms / 1e9,
                       "plain_ms": time_ms(lambda: c3.conv3x3_wgrad_plain(x, g), iters=3,
                                           warmup=1),
                       "library_ms": time_ms(library), "bound_ms": bnd, "bound_by": by,
                       "flops": flops, "bytes": nbytes, "max_abs_err": err,
                       "rel_err_of_max": rel, "bit_reproducible": True,
                       **wgrad_kernel_facts("conv3x3_wgrad.cu", o)})
        del x, g, dw_k
        torch.cuda.empty_cache()
    return {"name": "conv3x3_wgrad", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/conv3x3_wgrad.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/conv3x3_train.py:78",
            "tolerance": f"max error / max |dw| <= {WGRAD_REL}; bit-equal across runs",
            "per_step": 48, "path": "sd3unet_kernels_train_ae", "shapes": shapes}


def check_gn_swish_bwd(gen):
    """The GroupNorm + swish backward at every site shape of the sd3unet ae
    step, bit-equal across two runs, one kernel a call.  Library: autograd
    of F.group_norm and F.silu in bf16 (forward outside the timed region)."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import gn_swish_bwd as gsb
    from vqvae_from_gaussian_vae_tpu_torch.ops import grid_sync

    tol = LN_BWD_TOL["torch.bfloat16"]
    shapes = []
    for h, c, n in UNET_GN_SITES:
        x = (2 * torch.randn((BATCH, h, h, c), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        dy = torch.randn((BATCH, h, h, c), generator=gen, device="cuda").to(torch.bfloat16)
        gamma = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.2 * torch.randn((c,), generator=gen, device="cuda")
        _, (mean_c, rstd_c) = gsb.gn_swish_ref(x, gamma, beta)
        args = (x, dy, mean_c, rstd_c, gamma, beta)
        got, again = gsb.gn_swish_bwd_cuda(*args), gsb.gn_swish_bwd_cuda(*args)
        want = gsb.gn_swish_bwd_plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"GN + swish backward {(h, c)}: two runs differ")
        pcie = _grid_at_114(at_sms(PCIE_SMS, lambda: gsb.gn_swish_bwd_cuda(*args)), want, tol)
        require(pcie["err_over_tol"] <= 1.0 and pcie["param_grad_rel_err"] <= PARAM_GRAD_REL,
                f"GN + swish backward {(h, c)} on a {PCIE_SMS}-SM plan: {pcie}")
        pcie["plan"] = dataclasses.asdict(gsb.gn_bwd_plan(BATCH, h * h, c, 32, torch.bfloat16,
                                                          PCIE_SMS))
        dx_err, ratio = _within(got[0], want[0], tol, tol)
        require(ratio <= 1.0, f"GN + swish backward {(h, c)}: dx error {dx_err}")
        p_err = 0.0
        for g, wnt in zip(got[1:], want[1:]):
            rel = float((g - wnt).abs().max() / wnt.abs().max())
            require(rel <= PARAM_GRAD_REL, f"GN + swish backward {(h, c)}: dgamma/dbeta {rel}")
            p_err = max(p_err, rel)
        del got, again, want
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        wl = gamma.to(torch.bfloat16).requires_grad_()
        bl = beta.to(torch.bfloat16).requires_grad_()
        yl = F.silu(F.group_norm(xl, 32, wl, bl, 1e-6))
        dyl = dy.permute(0, 3, 1, 2)
        library = lambda: torch.autograd.grad(yl, (xl, wl, bl), dyl, retain_graph=True)  # noqa: E731
        flops = 35.0 * x.numel()  # both passes' float32 arithmetic, exp counted once
        nbytes = 2 * 3 * x.numel() + 4 * (2 * BATCH * c + 4 * c)
        bnd, by = bound_ms(flops, nbytes, PEAK_FP32)
        plan = gsb.gn_bwd_plan(BATCH, h * h, c, 32, torch.bfloat16,
                               grid_sync.device_sms(x.device))
        facts = {"plan": dataclasses.asdict(plan),
                 # one register's spill at the 512-thread cap (PERF.md)
                 **ptxas_facts("gn_swish_bwd.cu", "gn_swish_bwd_kernelI13__nv_bfloat16E",
                               spill_free=False),
                 **one_kernel_a_call(lambda: gsb.gn_swish_bwd_cuda(*args), "gn_swish_bwd_kernel")}
        shapes.append({"shape": f"x, dy ({BATCH},{h},{h},{c}) bf16", "per_step": n, **facts,
                       "kernel_ms": time_ms(lambda: gsb.gn_swish_bwd_cuda(*args)),
                       "plain_ms": time_ms(lambda: gsb.gn_swish_bwd_plain(*args), iters=3,
                                           warmup=1),
                       "library_ms": time_ms(library),
                       "library": "autograd of F.group_norm, F.silu (bf16)",
                       "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
                       "max_abs_err": dx_err, "err_over_tol": ratio,
                       "param_grad_rel_err": p_err, "bit_reproducible": True,
                       f"at_{PCIE_SMS}_sms": pcie})
        del x, dy, args, xl, yl
        torch.cuda.empty_cache()
    return {"name": "gn_swish_bwd", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/gn_swish_bwd.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/gn_swish_bwd.py:142",
            "tolerance": f"dx atol = rtol {tol} (bf16); dgamma, dbeta max error / max |value| "
                         f"<= {PARAM_GRAD_REL}; bit-equal across runs",
            "per_step": 42, "path": "sd3unet_kernels_train_ae", "shapes": shapes}


# ---------------------------------------------------------------------------
# the main paths


def lean_blocks(lq: int, lk: int):
    """Block sizes of the head-major op that its checks accept at (lq, lk)."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention_lean import BlockSizes

    bk = 512 if lk % 512 == 0 else lk
    return BlockSizes(block_q=min(lq, 256), block_k_major=bk, block_k=bk, block_b=1,
                      block_q_major_dkv=lq, block_k_major_dkv=bk, block_k_dkv=bk,
                      block_q_dkv=lq, block_k_major_dq=bk, block_k_dq=bk, block_q_dq=lq)


def _lean_inputs(gen, b, h, lq, lk, d, dtype="bfloat16"):
    import torch

    dt = getattr(torch, dtype)
    q, do = (torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dt) for _ in range(2))
    k, v = (torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dt) for _ in range(2))
    return q, k, v, do


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def check_flash_lean(gen):
    """The head-major op: one training call (the forward with z, then the
    backward) through the public ``flash_attention`` with a gradient, held
    to the plain versions, at each of ``FLASH_LEAN_SHAPES``; times of the
    call against the plain versions' and SDPA's (forward, backward by
    autograd) on the same head-major tensors."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl

    shapes = []
    for b, h, lq, lk, d in FLASH_LEAN_SHAPES:
        q, k, v, do = _lean_inputs(gen, b, h, lq, lk, d)
        scale, blocks = d ** -0.5, lean_blocks(lq, lk)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def call():
            o = fl.flash_attention(*leaves, scale, blocks)
            return (o, *torch.autograd.grad(o, leaves, do))

        got = [t.detach() for t in call()]
        _, z = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
        o_p, z_p = fl.flash_attention_res_plain(q, k, v, scale)
        want = fl.flash_attention_bwd_plain(q, k, v, o_p, z_p, do, scale)
        again = fl.flash_attention_bwd_cuda(q, k, v, got[0], z, do, scale)
        again2 = fl.flash_attention_bwd_cuda(q, k, v, got[0], z, do, scale)
        torch.cuda.synchronize()
        o_err = float((got[0].float() - o_p.float()).abs().max())
        z_err = float((z - z_p).abs().max())
        require(o_err <= FLASH_ATOL, f"head-major flash {(b, h, lq, lk, d)}: o error {o_err}")
        require(z_err <= Z_ATOL, f"head-major flash {(b, h, lq, lk, d)}: z error {z_err}")
        rels = []
        for name, g, w in zip("qkv", got[1:], want):
            rel = float((g.float() - w.float()).abs().max() / w.float().abs().max())
            require(rel <= FLASH_BWD_REL, f"head-major flash {(b, h, lq, lk, d)}: d{name} error "
                                          f"{rel} of max |grad|")
            rels.append(rel)
        require(all(torch.equal(x, y) for x, y in zip(again, again2)) and
                all(torch.equal(x, y) for x, y in zip(again, got[1:])),
                "head-major flash backward: two runs differ")
        err = max([o_err] + [float((g.float() - w.float()).abs().max())
                             for g, w in zip(got[1:], want)])
        del got, want, again, again2, o_p, z_p

        def plain():
            o, zz = fl.flash_attention_res_plain(q, k, v, scale)
            return fl.flash_attention_bwd_plain(q, k, v, o, zz, do, scale)

        ref = [t.clone().requires_grad_() for t in (q, k, v)]

        def library():
            o = F.scaled_dot_product_attention(*ref, scale=scale)
            return torch.autograd.grad(o, ref, do)

        def library_forward():
            with torch.no_grad():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)

        # the backward alone: the kernels on the forward's o and z, and
        # SDPA's backward on an output made beforehand
        o_k, z_k = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
        o_ref = F.scaled_dot_product_attention(*ref, scale=scale)

        def library_backward():
            return torch.autograd.grad(o_ref, ref, do, retain_graph=True)

        eq, ek = b * h * lq * d, b * h * lk * d
        flops_f, flops_b = 4.0 * b * h * lq * lk * d, 5 * 2.0 * b * h * lq * lk * d
        bytes_f = 2 * (2 * eq + 2 * ek) + 4 * b * h * lq         # q, k, v in; o, z out
        bytes_b = 2 * (3 * eq + 2 * ek) + 4 * b * h * lq + 2 * (eq + 2 * ek)
        bnd, by = bound_ms(flops_f + flops_b, bytes_f + bytes_b, PEAK_BF16)
        long = (b, h, lq, lk, d) == FLASH_LEAN_FLOW
        kernel_ms = time_ms(call)
        forward_ms = time_ms(lambda: fl.flash_attention_fwd_cuda(q, k, v, scale,
                                                                  save_residuals=True))
        backward_ms = time_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, o_k, z_k, do, scale))
        shapes.append({
            "shape": f"q ({b},{h},{lq},{d}), k, v ({b},{h},{lk},{d}) bf16: forward with z, "
                     "then dq, dk, dv",
            "main_path": long, "per_step": 1,
            "kernel_ms": kernel_ms, "tflops": (flops_f + flops_b) / kernel_ms / 1e9,
            "forward_ms": forward_ms, "forward_tflops": flops_f / forward_ms / 1e9,
            "forward_bound_ms": bound_ms(flops_f, bytes_f, PEAK_BF16)[0],
            "plain_ms": time_ms(plain, iters=3 if long else 10, warmup=1),
            "library_ms": time_ms(library), "library": "SDPA forward + backward (autograd)",
            "library_forward_ms": time_ms(library_forward),
            "backward_ms": backward_ms, "backward_tflops": flops_b / backward_ms / 1e9,
            "backward_bound_ms": bound_ms(flops_b, bytes_b, PEAK_BF16)[0],
            "library_backward_ms": time_ms(library_backward),
            "backward": flash_bwd_kernel_facts(d, lq, lk),
            "bound_ms": bnd, "bound_by": by,
            "flops": flops_f + flops_b, "bytes": bytes_f + bytes_b,
            "max_abs_err": err, "o_max_abs_err": o_err, "z_max_abs_err": z_err,
            "rel_err_dq_dk_dv": rels, "bit_reproducible": True,
            **flash_fwd_kernel_facts(d, lq, lk)})
        del q, k, v, do, leaves, ref, o_k, z_k, o_ref
        torch.cuda.empty_cache()
    return {"name": "flash_attention_lean", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_fwd_sm90.cuh, "
                      "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_bwd_sm90.cuh (D = 64, 128); "
                      "csrc/flash_fwd_sm90_wide.cuh, csrc/flash_bwd_sm90_wide.cuh (D = 256, 512)",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_attention.py:118",
            "counters": ["flash_attention_lean_fwd", "flash_attention_lean_bwd"],
            "tolerance": f"o bf16 atol {FLASH_ATOL}; z atol {Z_ATOL}; max error / max |grad| "
                         f"<= {FLASH_BWD_REL} per dq, dk, dv; bit-equal across runs",
            "per_step": 1, "path": "flash_head_major", "shapes": shapes}


def check_flash_lean_f32(gen):
    """The head-major op in float32 (split-TF32 tensor-core kernels; at
    D = 256 and 512 a block a share of D's columns): one training call
    through the public ``flash_attention`` with a gradient, held to the
    plain versions within ``FLASH_F32_REL`` of their largest value, TF32
    off, at each of ``FLASH_LEAN_SHAPES``, the backward bit-equal across
    runs; times of the call, its forward and its backward against the plain
    versions' and SDPA's (float32: forward, backward by autograd, and both),
    and the kernels SDPA runs in float32 (torch.profiler, once); at the
    full-size D = 256 and 512 shapes each kernel of the call timed alone.
    Two bounds: the CUDA cores' (the
    function's seven products at the float32 peak) and split TF32's (three
    tensor-core passes of them at the TF32 peak), the latter also for the
    forward and the backward alone."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl

    shapes, library_kernels = [], None
    for b, h, lq, lk, d in FLASH_LEAN_SHAPES:
        q, k, v, do = _lean_inputs(gen, b, h, lq, lk, d, "float32")
        scale, blocks = d ** -0.5, lean_blocks(lq, lk)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def call():
            o = fl.flash_attention(*leaves, scale, blocks)
            return (o, *torch.autograd.grad(o, leaves, do))

        got = [t.detach() for t in call()]
        _, z = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
        o_p, z_p = fl.flash_attention_res_plain(q, k, v, scale)
        want = fl.flash_attention_bwd_plain(q, k, v, o_p, z_p, do, scale)
        again = fl.flash_attention_bwd_cuda(q, k, v, got[0], z, do, scale)
        again2 = fl.flash_attention_bwd_cuda(q, k, v, got[0], z, do, scale)
        torch.cuda.synchronize()
        rels = [_rel(got[0], o_p), _rel(z, z_p)] + [_rel(g, w) for g, w in zip(got[1:], want)]
        for name, rel in zip(("o", "z", "dq", "dk", "dv"), rels):
            require(got[0].dtype == torch.float32 and rel <= FLASH_F32_REL,
                    f"float32 head-major flash {(b, h, lq, lk, d)}: {name} error {rel} of its "
                    "largest value")
        require(all(torch.equal(x, y) for x, y in zip(again, again2)) and
                all(torch.equal(x, y) for x, y in zip(again, got[1:])),
                "float32 head-major flash backward: two runs differ")
        err = max(float((g - w).abs().max()) for g, w in zip(got, [o_p, *want]))
        full_wide = d >= 256 and lq >= 1024
        del got, want, o_p, z_p, again, again2

        def plain():
            o, zz = fl.flash_attention_res_plain(q, k, v, scale)
            return fl.flash_attention_bwd_plain(q, k, v, o, zz, do, scale)

        ref = [t.clone().requires_grad_() for t in (q, k, v)]

        def library():
            o = F.scaled_dot_product_attention(*ref, scale=scale)
            return torch.autograd.grad(o, ref, do)

        def library_forward():
            with torch.no_grad():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)

        # the backward alone: the kernels on the forward's o and z, and
        # SDPA's backward on an output made beforehand
        o_k, z_k = fl.flash_attention_fwd_cuda(q, k, v, scale, save_residuals=True)
        o_ref = F.scaled_dot_product_attention(*ref, scale=scale)

        def library_backward():
            return torch.autograd.grad(o_ref, ref, do, retain_graph=True)

        if library_kernels is None:  # which kernels SDPA runs in float32, TF32 off
            library_kernels = {"forward": device_kernels(library_forward),
                               "backward": device_kernels(library_backward)}
        eq, ek = b * h * lq * d, b * h * lk * d
        flops_f, flops_b = 4.0 * b * h * lq * lk * d, 5 * 2.0 * b * h * lq * lk * d
        bytes_f = 4 * (2 * eq + 2 * ek) + 4 * b * h * lq         # q, k, v in; o, z out
        bytes_b = 4 * (3 * eq + 2 * ek) + 4 * b * h * lq + 4 * (eq + 2 * ek)
        # the CUDA cores' bound (float32 outside the tensor cores) and split
        # TF32's (three passes of the same products at the TF32 peak: the
        # bodies'); each part's split-TF32 bound alone
        cores, _ = bound_ms(flops_f + flops_b, bytes_f + bytes_b, PEAK_FP32)
        bnd, by = bound_ms(3 * (flops_f + flops_b), bytes_f + bytes_b, PEAK_TF32)
        facts = flash_f32_kernel_facts(b, h, lq, lk, d)
        long = (b, h, lq, lk, d) == FLASH_LEAN_FLOW
        n = 3 if long else 10
        kernel_ms = time_ms(call, iters=n, warmup=1)
        forward_ms = time_ms(lambda: fl.flash_attention_fwd_cuda(
            q, k, v, scale, save_residuals=True), iters=n, warmup=1)
        backward_ms = time_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, o_k, z_k, do, scale),
                              iters=n, warmup=1)
        shapes.append({
            "shape": f"q ({b},{h},{lq},{d}), k, v ({b},{h},{lk},{d}) float32: forward with z, "
                     "then dq, dk, dv",
            "main_path": long, "per_step": 1,
            "kernel_ms": kernel_ms, "tflops": (flops_f + flops_b) / kernel_ms / 1e9,
            "forward_ms": forward_ms, "forward_tflops": flops_f / forward_ms / 1e9,
            "backward_ms": backward_ms, "backward_tflops": flops_b / backward_ms / 1e9,
            "plain_ms": time_ms(plain, iters=n, warmup=1),
            "library_ms": time_ms(library), "library": "SDPA forward + backward (autograd), "
                                                       "float32",
            "library_forward_ms": time_ms(library_forward),
            "library_backward_ms": time_ms(library_backward),
            "bound_ms": bnd, "bound_by": by,
            "cuda_core_bound_ms": cores, "split_tf32_bound_ms": bnd,
            "forward_bound_ms": bound_ms(3 * flops_f, bytes_f, PEAK_TF32)[0],
            "backward_bound_ms": bound_ms(3 * flops_b, bytes_b, PEAK_TF32)[0],
            # the port's products: two forward, seven backward (two recomputed)
            "split_tf32_bound_port_ms": 1e3 * 3 * 9 * 2.0 * b * h * lq * lk * d / PEAK_TF32,
            "flops": flops_f + flops_b, "bytes": bytes_f + bytes_b,
            "max_abs_err": err, "rel_err_o_z_dq_dk_dv": rels, "bit_reproducible": True,
            # each kernel of the call alone (pre-pass, forward, dK/dV, dQ)
            **facts, **({"kernel_device_ms": device_kernel_ms(call, iters=3)}
                        if full_wide else {})})
        del q, k, v, do, leaves, ref, o_k, z_k, o_ref
        torch.cuda.empty_cache()
    return {"name": "flash_attention_lean_f32", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_fwd_f32_sm90.cuh, "
                      "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_bwd_f32_sm90.cuh "
                      "(D = 64, 128); csrc/flash_fwd_f32_sm90_wide.cuh, "
                      "csrc/flash_bwd_f32_sm90_wide.cuh (D = 256, 512)",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_attention.py:118",
            "counters": ["flash_attention_lean_fwd", "flash_attention_lean_bwd"],
            "tolerance": f"o, z, dq, dk, dv: max error / max |value| <= {FLASH_F32_REL} "
                         "(float32, TF32 off); the backward bit-equal across runs",
            "library_kernels": library_kernels,
            "per_step": 1, "path": "flash_head_major_f32", "shapes": shapes}


def launch_counters():
    from vqvae_from_gaussian_vae_tpu_torch.ops import conv3x3_train, downsample_conv
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention, fused_gn_conv, gn_swish_bwd
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean, flash_lab
    from vqvae_from_gaussian_vae_tpu_torch.ops import gq_cuda, layer_norm, ln_matmul, upsample_conv

    return {"gq_argmax": gq_cuda.gq_argmax_cuda,
            "downsample_conv3x3_gn": downsample_conv.downsample_conv3x3_gn_cuda,
            "upsample_nearest_conv3x3_gn": upsample_conv.upsample_nearest_conv3x3_gn_cuda,
            "flash_attention_fwd": flash_attention.flash_attention_cuda,
            "flash_attention_qkv_fwd": flash_attention.flash_attention_qkv_cuda,
            "flash_attention_qkv_res_fwd": flash_attention.flash_attention_qkv_res_cuda,
            "flash_attention_qkv_bwd": flash_attention.flash_attention_qkv_bwd_cuda,
            "layer_norm_fwd": layer_norm.layer_norm_cuda,
            "layer_norm_add_fwd": layer_norm.layer_norm_add_cuda,
            "layer_norm_bwd": layer_norm.layer_norm_bwd_cuda,
            "layer_norm_add_bwd": layer_norm.layer_norm_add_bwd_cuda,
            "downsample_dgrad": downsample_conv.downsample_dgrad_cuda,
            "downsample_wgrad": downsample_conv.downsample_wgrad_cuda,
            "upsample_dgrad": upsample_conv.upsample_dgrad_cuda,
            "upsample_wgrad": upsample_conv.upsample_wgrad_cuda,
            "flash_attention_res_fwd": flash_attention.flash_attention_res_cuda,
            "flash_attention_bwd": flash_attention.flash_attention_bwd_cuda,
            "fused_gn_swish_conv": fused_gn_conv.fused_gn_swish_conv_cuda,
            "conv3x3_wgrad": conv3x3_train.conv3x3_wgrad_cuda,
            "gn_swish_bwd": gn_swish_bwd.gn_swish_bwd_cuda,
            "flash_attention_lean_fwd": flash_attention_lean.flash_attention_fwd_cuda,
            "flash_attention_lean_bwd": flash_attention_lean.flash_attention_bwd_cuda,
            "flash_variant": flash_lab.flash_variant_cuda,
            "flash_fwd_tiling": flash_lab.flash_fwd_tiling_cuda,
            "flash_bwd_tiling": flash_lab.flash_bwd_tiling_cuda,
            "flash_bwd_control": flash_lab.flash_bwd_control_cuda,
            "ln_matmul": ln_matmul.ln_matmul_cuda,
            "matmul_bias": ln_matmul.matmul_bias_cuda}


def counted(counters, fn):
    """Run fn with every launch count set to 0 just before it; return
    (fn's result, the counts just after)."""
    import torch

    for k in counters.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in counters.items()}


def require_launches(label, got, expected):
    want = {name: expected.get(name, 0) for name in got}
    require(got == want, f"{label}: launches {got} != {want}")
    return {name: n for name, n in got.items() if name in expected}


def _backbone_flops(kind: str, enc_cfg):
    """(encoder, decoder) FLOP per image of a backbone."""
    from vqvae_from_gaussian_vae_tpu_torch.utils import flops as F

    if kind == "unet":
        return F.unet_encoder_flops(enc_cfg), F.unet_decoder_flops(enc_cfg)
    return F.vit_flops(enc_cfg), F.vit_decoder_flops(enc_cfg)


# each main path: its config (and the backbones' overrides), the launches of
# one encode -> dequant step (every counter not named is 0), its latent and
# index shapes (one index group per latent pixel or token), and its FLOP per
# image besides the search
UNET_FUSED = {"fused_gn_conv": True}
PATHS = {
    "sd3unet": {"config": "configs/sd3unet_gq_0.25.yaml",
                "launches": {"gq_argmax": 1, "downsample_conv3x3_gn": 3,
                             "upsample_nearest_conv3x3_gn": 3, "flash_attention_fwd": 5},
                "z": (BATCH, 32, 32, 16), "indices": (BATCH, 32, 32, 1),
                "flops": lambda cfg: sum(_backbone_flops("unet", cfg))},
    "bsqvit": {"config": "configs/bsqvit_gq_0.25.yaml",
               "launches": {"gq_argmax": 1, "flash_attention_qkv_fwd": 24,
                            "layer_norm_fwd": 6, "layer_norm_add_fwd": 46},
               "z": (BATCH, 32 * 32, 16), "indices": (BATCH, 32 * 32, 1),
               "flops": lambda cfg: sum(_backbone_flops("vit", cfg))},
    "sd3unet_fused_gn_conv": {"config": "configs/sd3unet_gq_0.25.yaml", "overrides": UNET_FUSED,
                              "launches": {"gq_argmax": 1, "downsample_conv3x3_gn": 3,
                                           "upsample_nearest_conv3x3_gn": 3,
                                           "flash_attention_fwd": 5, "fused_gn_swish_conv": 48},
                              "z": (BATCH, 32, 32, 16), "indices": (BATCH, 32, 32, 1),
                              "flops": lambda cfg: sum(_backbone_flops("unet", cfg))},
}


def _set_backbones(params, dtype: str, overrides) -> None:
    for key in ("encoder_config", "decoder_config"):
        params[key]["params"]["dtype"] = dtype
        params[key]["params"].update(overrides)


def build_engine(config: str, dtype: str, overrides=None):
    from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config

    cfg = load_config(os.path.join(ROOT, config))
    params = cfg["model"]["params"]
    params["loss_config"] = None
    _set_backbones(params, dtype, overrides or {})
    return instantiate_from_config(cfg["model"], seed=SEED, device="cuda"), cfg


# the GAN training pairs, each config plus the bf16 overlay (and the
# backbones' overrides, and the environment set around the pair): launches of
# one ae step (both trunks with a gradient), one disc step (both trunks
# without: encode in the train branch, decode on the inference path) and one
# eval step; the parameters whose change the run checks; the latent tokens of
# an image (eps's shape)
BF16_OVERLAY = "configs/overlays/bf16_compute.yaml"
UNET_AE = {"downsample_conv3x3_gn": 3, "downsample_dgrad": 3, "downsample_wgrad": 3,
           "upsample_nearest_conv3x3_gn": 3, "upsample_dgrad": 3, "upsample_wgrad": 3,
           "flash_attention_res_fwd": 5, "flash_attention_bwd": 5}
UNET_DISC = {"downsample_conv3x3_gn": 3, "upsample_nearest_conv3x3_gn": 3,
             "flash_attention_fwd": 5}
UNET_WATCHED = ["decoder.conv_out.weight", "encoder.down.0.downsample.conv.weight",
                "decoder.up.1.upsample.conv.weight", "encoder.down.3.attn.0.q.weight"]
TRAIN_PATHS = {
    "bsqvit": {
        "configs": ["configs/bsqvit_gq_0.25.yaml", BF16_OVERLAY],
        "launches": {
            "ae": {"flash_attention_qkv_res_fwd": 24, "flash_attention_qkv_bwd": 24,
                   "layer_norm_fwd": 6, "layer_norm_add_fwd": 46, "layer_norm_bwd": 6,
                   "layer_norm_add_bwd": 46},
            "disc": {"flash_attention_qkv_fwd": 24, "layer_norm_fwd": 6,
                     "layer_norm_add_fwd": 46},
            "eval": {"gq_argmax": 1, "flash_attention_qkv_fwd": 24, "layer_norm_fwd": 6,
                     "layer_norm_add_fwd": 46}},
        "watched": ["decoder.conv_out.weight",
                    "encoder.transformer.resblocks.0.attn.in_proj_weight"],
        "tokens": 32 * 32, "backbone_flops": lambda cfg: _backbone_flops("vit", cfg)},
    "sd3unet": {
        "configs": ["configs/sd3unet_gq_0.25.yaml", BF16_OVERLAY],
        "launches": {"ae": UNET_AE, "disc": UNET_DISC, "eval": {"gq_argmax": 1, **UNET_DISC}},
        "watched": UNET_WATCHED,
        "tokens": 32 * 32, "backbone_flops": lambda cfg: _backbone_flops("unet", cfg)},
    # the UNet's default-off kernels: the fused GN conv on the disc step's
    # decode and the eval step, the conv wgrad and the GN + swish backward
    # in the ae step (42 sites: 48 less the 6 that take a resample's stats)
    "sd3unet_kernels": {
        "configs": ["configs/sd3unet_gq_0.25.yaml", BF16_OVERLAY],
        "overrides": UNET_FUSED, "env": {"GVQ_CONV_WGRAD": "1", "GVQ_GN_BWD": "1"},
        "launches": {"ae": {**UNET_AE, "conv3x3_wgrad": 48, "gn_swish_bwd": 42},
                     "disc": {**UNET_DISC, "fused_gn_swish_conv": 28},
                     "eval": {"gq_argmax": 1, **UNET_DISC, "fused_gn_swish_conv": 48}},
        "watched": UNET_WATCHED + ["encoder.down.0.block.0.norm1.weight"],
        "tokens": 32 * 32, "backbone_flops": lambda cfg: _backbone_flops("unet", cfg)},
}
TRAIN_WARMUP, TRAIN_TIMED = 2, 5

# the regularizers phase: the sd3unet configs whose regularizer (or vf
# branch) is not the GQ pair's, each with the bf16 overlay at full width and
# one resblock a level (for the smoke's time; at full depth their pairs ran
# within 3% of the GQ pair's but FSQ's, PERF.md §5): launches of one ae, disc and eval
# step, whose 32x32 level holds one AttnBlock in the encoder and two in the
# decoder (flash 3 a step, not 5).  VQ and GQ2 search on every
# forward (the GQ search kernel, B1); FSQ, LFQ, BSQ and the Gaussian search
# on none.  The vf config's frozen DINOv2 ViT-L runs 48 LayerNorm launches
# (B6a) a forward (the ae and eval steps), and its adaptive vf weight's nll
# gradient adds a backward through the decoder: 3 upsample dgrad and wgrad,
# 3 flash backward.
B1 = {"gq_argmax": 1}
VF_TRUNK = {"layer_norm_fwd": 48}
REG_DEPTH = {"num_res_blocks": 1}
REG_AE = {**UNET_AE, "flash_attention_res_fwd": 3, "flash_attention_bwd": 3}
REG_DISC = {**UNET_DISC, "flash_attention_fwd": 3}
REG_AE_VF = {**REG_AE, "upsample_dgrad": 6, "upsample_wgrad": 6, "flash_attention_bwd": 5,
             **VF_TRUNK}
PLAIN_REG = {"ae": REG_AE, "disc": REG_DISC, "eval": REG_DISC}
SEARCH_REG = {"ae": {**REG_AE, **B1}, "disc": {**REG_DISC, **B1}, "eval": {**REG_DISC, **B1}}
REG_PATHS = {
    "sd3unet_vq_16": {"search": "vq", "launches": SEARCH_REG, "grad_check": True,
                      "entry_point": True, "watched": ["regularization.embedding.weight"]},
    "sd3unet_fsq_16": {"launches": PLAIN_REG},
    "sd3unet_lfq_16": {"launches": PLAIN_REG},
    "sd3unet_bsq_16": {"launches": PLAIN_REG},
    "sd3unet_gq2_0.25": {"search": "gq2", "launches": SEARCH_REG, "duals": True},
    "sd3unet_gaussian_kl_0.64": {"launches": PLAIN_REG, "indices": False},
    "sd3unet_gq_0.25_gaussian": {"launches": PLAIN_REG, "indices": False},
    "sd3unet_gq_0.25_vf": {"launches": {"ae": REG_AE_VF, "disc": REG_DISC,
                                        "eval": {**REG_DISC, **B1, **VF_TRUNK}},
                           "grad_check": True, "entry_point": True, "duals": True,
                           "watched": ["linear_proj.weight"],
                           "frozen": "foundation.blocks.0.attn.in_proj_weight"},
}
for _name, _spec in REG_PATHS.items():
    _spec.update(configs=[f"configs/{_name}.yaml", BF16_OVERLAY], tokens=32 * 32,
                 overrides=REG_DEPTH)
REG_TIMED = 1  # timed pairs after one counted warm-up pair
REG_ENTRY_IMAGES = 32  # the training entry point's folder: 2 steps at bs=16


def _train_spec(path: str) -> dict:
    return TRAIN_PATHS[path] if path in TRAIN_PATHS else REG_PATHS[path]


def build_trainer(path: str, dtype: str, seed: int = SEED, overrides=None):
    from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
    from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import make_optimizers
    from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder

    spec = _train_spec(path)
    cfg = load_config([os.path.join(ROOT, c) for c in spec["configs"]])
    params = cfg["model"]["params"]
    params.pop("ckpt_path", None)  # seeded weights: no checkpoint file is shipped
    _set_backbones(params, dtype, {**spec.get("overrides", {}), **(overrides or {})})
    params["loss_config"]["params"]["dtype"] = dtype
    engine = instantiate_from_config(cfg["model"], seed=seed, device="cuda")
    return engine, TrainStepBuilder(engine, *make_optimizers(1e-4)), cfg


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def run_e2e(gen, profile: bool, path: str):
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import argmax_blocked, score_operands
    from vqvae_from_gaussian_vae_tpu_torch.quantization.gaussian import _split_posterior
    from vqvae_from_gaussian_vae_tpu_torch.utils import flops as F

    spec = PATHS[path]
    torch.cuda.reset_peak_memory_stats()
    engine, cfg = build_engine(spec["config"], "bfloat16", spec.get("overrides"))
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    counters = launch_counters()

    # the main path, counted: encode -> GQ search -> dequant
    for fn in counters.values():
        fn.launches = 0
    z, reg = engine.encode(x, return_reg_log=True)
    xhat = engine.dequant(reg["indices"])
    torch.cuda.synchronize()
    all_launches = {name: fn.launches for name, fn in counters.items()}
    expected = {name: spec["launches"].get(name, 0) for name in counters}
    require(all_launches == expected, f"{path}: launches per step {all_launches} != {expected}")
    launches = {name: n for name, n in all_launches.items() if name in spec["launches"]}

    idx = reg["indices"]
    require(tuple(z.shape) == spec["z"], f"z shape {tuple(z.shape)}")
    require(tuple(idx.shape) == spec["indices"] and idx.dtype == torch.int32,
            f"indices {tuple(idx.shape)} {idx.dtype}")
    require(int(idx.min()) >= 0 and int(idx.max()) < 65536, "index out of range")
    require(tuple(xhat.shape) == (BATCH, RES, RES, 3), f"xhat shape {tuple(xhat.shape)}")
    require(bool(torch.isfinite(xhat.float()).all()), "dequant output not finite")
    require(bool(torch.isfinite(z).all()), "zhat not finite")

    # dequant(indices) must be decode(zhat): the same latents through the same
    # decoder, and the engine's clamp
    xrec = engine.module._clamp(engine.decode(z))
    deq_err = float((xrec.float() - xhat.float()).abs().max())
    require(deq_err <= FLASH_ATOL, f"dequant(indices) vs decode(zhat) differ by {deq_err}")

    # the card's indices against the plain search of the same posterior
    zraw, _ = engine.encode(x, unregularized=True)
    reg_mod = engine.regularization
    mu, _, std = _split_posterior(zraw.reshape(BATCH, 32 * 32, -1), reg_mod.logvar_range)
    mu_r, std_r = reg_mod.rows(mu), reg_mod.rows(std)
    want = argmax_blocked(*score_operands(mu_r, std_r, reg_mod.codebook, reg_mod.beta))
    got = idx.reshape(-1)
    mismatches = int((got != want).sum())
    gap = near_tie_gap(got, want, mu_r, std_r, reg_mod.codebook)

    # a small input against a float32 engine of the same weights (plain convs,
    # einsum attention; TF32 off)
    ref_engine, _ = build_engine(spec["config"], "float32", spec.get("overrides"))
    xs = x[:2]
    z16, _ = engine.encode(xs, unregularized=True)
    z32, _ = ref_engine.encode(xs, unregularized=True)
    zhat_small, _ = engine.encode(xs, return_reg_log=True)
    d16 = engine.decode(zhat_small)
    d32 = ref_engine.decode(zhat_small)
    enc_rel, dec_rel = rel_l2(z16, z32), rel_l2(d16, d32)
    require(enc_rel <= 0.1 and dec_rel <= 0.1,
            f"bf16 engine vs float32 engine: encoder rel L2 {enc_rel}, decoder {dec_rel}")
    del ref_engine
    torch.cuda.empty_cache()

    # throughput of chained encode -> dequant steps
    def step():
        _, r = engine.encode(x, return_reg_log=True)
        return engine.dequant(r["indices"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    enc_cfg = cfg["model"]["params"]["encoder_config"]["params"]
    step_flops = BATCH * (spec["flops"](enc_cfg) + F.gq_search_flops(32 * 32, 16, 65536))
    result = {"phase": "e2e", "path": path, "config": spec["config"],
              "overrides": spec.get("overrides", {}), "dtype": "bfloat16",
              "batch": BATCH, "resolution": RES, "launches_per_step": launches,
              "z": list(z.shape), "indices": list(idx.shape), "xhat": list(xhat.shape),
              "dequant_vs_decode_max_abs": deq_err,
              "gq_vs_plain_mismatches": mismatches, "gq_max_near_tie_gap": gap,
              "bf16_vs_fp32_rel_l2": {"encoder": enc_rel, "decoder": dec_rel},
              "step_ms": 1e3 * dt / iters, "img_per_s": BATCH * iters / dt,
              "step_flops": step_flops,
              "achieved_tflops": step_flops * iters / dt / 1e12,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if path == "bsqvit":
        result["float32_master_weights"] = stored_weights_cost(engine, step, iters)
    if profile:
        result["profile"] = profile_step(step)
    return result


def stored_weights_cost(engine, step, iters):
    """What float32 master weights cost the inference step: the step as it
    runs (the Linear weights cast to bf16 at each use) against the same step
    with the weights stored in bf16 (the casts then no-ops), in turns."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.models.vit import CastLinear, MultiheadAttention

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters

    params = []
    for m in engine.module.modules():
        if isinstance(m, CastLinear):
            params += [(p, m.compute_dtype) for p in (m.weight, m.bias) if p is not None]
        elif isinstance(m, MultiheadAttention):
            params += [(m.in_proj_weight, m.dtype), (m.in_proj_bias, m.dtype)]
    masters = [p.data for p, _ in params]
    cast = [run()]
    for p, dt in params:
        p.data = p.data.to(dt)
    stored = [run(), run()]
    for (p, _), master in zip(params, masters):
        p.data = master
    cast.append(run())
    return {"cast_at_use_ms": cast, "stored_bf16_ms": stored,
            "cost_ms": sum(cast) / 2 - sum(stored) / 2}


def _finite(log) -> bool:
    import torch

    return all(bool(torch.isfinite(v).all()) for v in log.values())


def with_env(env, fn):
    """fn() with the variables of ``env`` set, then restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_train(gen, profile: bool, path: str):
    """The two-phase GAN pair of one config (``TRAIN_PATHS``) at full width
    and depth, bs=16, 256x256, bf16 compute with float32 master weights,
    through the entry points a user calls: config -> engine with its loss ->
    make_optimizers -> TrainStepBuilder -> init_state -> ae_step / disc_step
    -> eval_step; the path's environment is set around it and restored."""
    return with_env(TRAIN_PATHS[path].get("env", {}), lambda: _run_train(gen, profile, path))


def _run_train(gen, profile: bool, path: str):
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.utils import flops as F

    spec = TRAIN_PATHS[path]
    torch.cuda.reset_peak_memory_stats()
    engine, builder, cfg = build_trainer(path, "bfloat16")
    require(all(p.dtype == torch.float32 for _, p in builder.ae_named_parameters()
                + builder.disc_named_parameters()), "a trained parameter is not float32")
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    x2 = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    batch, batch2 = {"img": x}, {"img": x2}
    state = builder.init_state(SEED, batch)
    state.step = engine.loss.disc_start + 10  # both phases run their real graphs
    counters = launch_counters()
    require(builder.last_layer_path == "decoder.conv_out.weight",
            f"the adaptive weight's last layer is {builder.last_layer_path}")
    watched = {name: engine.module.get_parameter(name) for name in spec["watched"]}
    watched["loss.logvar"] = engine.loss.logvar
    watched["loss.discriminator.main.0.weight"] = engine.loss.discriminator.main[0].weight
    before = {k: p.detach().clone() for k, p in watched.items()}
    duals0 = {k: float(v) for k, v in state.duals.items()}

    (state_log, ae_counts) = counted(counters, lambda: builder.ae_step(state, batch, True))
    _, log = state_log
    duals_ae = {k: float(v) for k, v in state.duals.items()}
    ae_launches = require_launches(f"{path} ae step", ae_counts, spec["launches"]["ae"])
    require(_finite(log), f"{path} ae step: a loss is not finite: {log}")
    d_weight = float(log["train/scalars/d_weight"])
    require(d_weight > 0.0, f"{path} ae step: d_weight {d_weight} is not positive")
    (state_log, disc_counts) = counted(counters, lambda: builder.disc_step(state, batch))
    _, log_d = state_log
    disc_launches = require_launches(f"{path} disc step", disc_counts, spec["launches"]["disc"])
    require(_finite(log_d), f"{path} disc step: a loss is not finite: {log_d}")
    (log_e, eval_counts) = counted(counters, lambda: builder.eval_step(state, batch2))
    eval_launches = require_launches(f"{path} eval step", eval_counts, spec["launches"]["eval"])
    require(_finite(log_e), f"{path} eval step: a loss is not finite: {log_e}")
    moved = {k: float((p.detach() - before[k]).abs().max()) for k, p in watched.items()}
    require(all(v > 0 for v in moved.values()), f"a parameter did not change: {moved}")
    duals1 = {k: float(v) for k, v in state.duals.items()}
    # lam moves by a factor lam_factor or its inverse on every training forward
    require(duals_ae["lam"] != duals0["lam"] and duals1["lam"] != duals_ae["lam"],
            f"the duals did not change: {duals0} -> {duals_ae} -> {duals1}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    for _ in range(TRAIN_WARMUP):
        builder.ae_step(state, batch, True)
        builder.disc_step(state, batch)
    ae_ms, disc_ms = [], []
    for _ in range(TRAIN_TIMED):
        ae_ms.append(timed(lambda: builder.ae_step(state, batch, True)))
        disc_ms.append(timed(lambda: builder.disc_step(state, batch)))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ae_mean, disc_mean = sum(ae_ms) / len(ae_ms), sum(disc_ms) / len(disc_ms)
    enc_cfg = cfg["model"]["params"]["encoder_config"]["params"]
    disc_cfg = cfg["model"]["params"]["loss_config"]["params"]["discriminator_config"]["params"]
    fl = F.gan_train_step_flops_from_backbone(
        *spec["backbone_flops"](enc_cfg), img=RES, ndf=disc_cfg["ndf"],
        n_layers=disc_cfg["n_layers"])
    pair_flops = BATCH * (fl["ae_step"] + fl["disc_step"])
    tflops = pair_flops / ((ae_mean + disc_mean) / 1e3) / 1e12
    result = {"phase": "train", "path": path, "configs": spec["configs"],
              "overrides": spec.get("overrides", {}), "env": spec.get("env", {}),
              "dtype": "bfloat16 compute, float32 parameters",
              "batch": BATCH, "resolution": RES, "step": state.step,
              "launches_per_ae_step": ae_launches, "launches_per_disc_step": disc_launches,
              "launches_per_eval_step": eval_launches,
              "ae_log": {k: float(v) for k, v in log.items()},
              "disc_log": {k: float(v) for k, v in log_d.items()},
              "eval_log": {k: float(v) for k, v in log_e.items()},
              "param_max_change": moved, "duals": {"before": duals0, "after_ae": duals_ae, "after_disc": duals1},
              "ae_ms": ae_mean, "disc_ms": disc_mean, "ae_ms_all": ae_ms,
              "disc_ms_all": disc_ms, "pair_img_per_s": 2 * BATCH / ((ae_mean + disc_mean) / 1e3),
              "pair_flops": pair_flops, "flops_accounting": "gan_train_step_flops_from_backbone",
              "achieved_tflops": tflops, "bf16_peak_share": tflops * 1e12 / PEAK_BF16,
              "peak_mem_gib": peak_gib}
    if profile:
        result["profile_ae"] = profile_step(lambda: builder.ae_step(state, batch, True))
        result["profile_disc"] = profile_step(lambda: builder.disc_step(state, batch))
    result["bf16_vs_fp32_grad"] = train_grad_check(path, engine, builder, state, gen)
    del builder, engine
    torch.cuda.empty_cache()
    return result


def train_grad_check(path, engine, builder, state, gen):
    """One ae step's gradient of the bf16 engine against a float32 engine
    with the same weights (engine and loss head), batch and eps, at bs=2;
    TF32 is off.  A tensor whose float32 gradient is zero in exact
    arithmetic (``ZERO_GRAD_REL``) has no relative error and is reported
    apart."""
    import torch

    ref_engine, ref_builder, _ = build_trainer(path, "float32")
    ref_engine.load_state_dict(engine.state_dict())
    ref_engine.loss.load_state_dict(engine.loss.state_dict())
    x = torch.rand((2, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    eps = torch.randn((2, _train_spec(path)["tokens"], engine.encoder.z_channels), generator=gen,
                      device="cuda")
    g16, log16, _ = builder.ae_grads(state, {"img": x}, True, eps=eps)
    g32, log32, _ = ref_builder.ae_grads(state, {"img": x}, True, eps=eps)
    whole = float(torch.cat([g.flatten() for g in g32.values()]).double().norm())
    zero = {k: [float(g16[k].double().norm()), float(g32[k].double().norm())]
            for k in g32 if float(g32[k].double().norm()) < ZERO_GRAD_REL * whole}
    per = {k: rel_l2(g16[k], g32[k]) for k in g32 if k not in zero}
    worst = max(per, key=per.get)
    total = rel_l2(torch.cat([g16[k].flatten() for k in g32]),
                   torch.cat([g32[k].flatten() for k in g32]))
    require(total <= TRAIN_GRAD_REL_L2,
            f"{path} bf16 vs float32 ae gradient: rel L2 {total} (worst {worst}: {per[worst]})")
    require(per[worst] <= TRAIN_GRAD_TENSOR_REL_L2,
            f"{path} bf16 vs float32 ae gradient of {worst}: rel L2 {per[worst]}")
    del ref_builder, ref_engine
    torch.cuda.empty_cache()
    top = sorted(per, key=per.get, reverse=True)[:5]
    return {"batch": 2, "rel_l2_all": total, "worst_tensor": worst, "worst_rel_l2": per[worst],
            "next_worst": {k: per[k] for k in top[1:]},
            "zero_gradient_tensors": zero,
            "d_weight": [float(log16["train/scalars/d_weight"]),
                         float(log32["train/scalars/d_weight"])],
            "loss_total": [float(log16["train/loss/total"]), float(log32["train/loss/total"])]}


def _host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def run_regularizer(gen, path: str) -> dict:
    """One config of ``REG_PATHS`` at full width and depth, bs=16, 256x256,
    the bf16 overlay: a warm-up ae + disc pair with exact launches, then
    ``REG_TIMED`` timed pairs and an eval step; parameters that move (and a
    frozen trunk that does not), the duals where the regularizer has them;
    for a regularizer with indices, encode -> dequant against decode, and
    VQ's and GQ2's card indices against the plain search of the same
    latents; for VQ and vf one ae step's bf16 gradient against a float32
    engine's."""
    import torch

    spec = REG_PATHS[path]
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    engine, builder, _ = build_trainer(path, "bfloat16")
    build_s = time.perf_counter() - t_build
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    x2 = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    batch = {"img": x}
    state = builder.init_state(SEED, batch)
    state.step = engine.loss.disc_start + 10  # both phases run their real graphs
    counters = launch_counters()
    names = ["encoder.conv_out.weight", "decoder.conv_out.weight"] + spec.get("watched", [])
    watched = {n: engine.module.get_parameter(n) for n in names}
    before = {k: p.detach().clone() for k, p in watched.items()}
    frozen = spec.get("frozen")
    frozen_before = engine.module.get_parameter(frozen).detach().clone() if frozen else None
    duals0 = {k: float(v) for k, v in state.duals.items()}

    (_, log), ae_counts = counted(counters, lambda: builder.ae_step(state, batch, True))
    ae_launches = require_launches(f"{path} ae step", ae_counts, spec["launches"]["ae"])
    require(_finite(log), f"{path} ae step: a loss is not finite: {log}")
    (_, log_d), disc_counts = counted(counters, lambda: builder.disc_step(state, batch))
    disc_launches = require_launches(f"{path} disc step", disc_counts, spec["launches"]["disc"])
    require(_finite(log_d), f"{path} disc step: a loss is not finite: {log_d}")
    ae_ms, disc_ms = [], []
    for _ in range(REG_TIMED):
        ae_ms.append(_host_ms(lambda: builder.ae_step(state, batch, True)))
        disc_ms.append(_host_ms(lambda: builder.disc_step(state, batch)))
    log_e, eval_counts = counted(counters, lambda: builder.eval_step(state, {"img": x2}))
    eval_launches = require_launches(f"{path} eval step", eval_counts, spec["launches"]["eval"])
    require(_finite(log_e), f"{path} eval step: a loss is not finite: {log_e}")
    moved = {k: float((p.detach() - before[k]).abs().max()) for k, p in watched.items()}
    require(all(v > 0 for v in moved.values()), f"{path}: a parameter did not change: {moved}")
    if frozen:
        require(torch.equal(engine.module.get_parameter(frozen), frozen_before),
                f"{path}: the frozen {frozen} changed")
    duals1 = {k: float(v) for k, v in state.duals.items()}
    require((duals1 != duals0) == bool(spec.get("duals")),
            f"{path}: duals {duals0} -> {duals1}")
    ae_mean, disc_mean = sum(ae_ms) / len(ae_ms), sum(disc_ms) / len(disc_ms)
    result = {"phase": "regularizers", "path": path, "configs": spec["configs"],
              "overrides": spec["overrides"],
              "regularizer": type(engine.regularization).__name__,
              "dtype": "bfloat16 compute, float32 parameters", "batch": BATCH,
              "resolution": RES, "build_s": build_s,
              "launches_per_ae_step": ae_launches, "launches_per_disc_step": disc_launches,
              "launches_per_eval_step": eval_launches,
              "ae_log": {k: float(v) for k, v in log.items()},
              "eval_log": {k: float(v) for k, v in log_e.items()},
              "param_max_change": moved, "duals": {"before": duals0, "after": duals1},
              "ae_ms": ae_mean, "disc_ms": disc_mean, "ae_ms_all": ae_ms,
              "disc_ms_all": disc_ms,
              "pair_img_per_s": 2 * BATCH / ((ae_mean + disc_mean) / 1e3)}
    if spec.get("indices", True):
        result["tokenization"] = _check_tokens(path, engine, x)
    else:
        z, reg = engine.encode(x, return_reg_log=True)
        require("indices" not in reg and bool(torch.isfinite(z).all()),
                f"{path}: the Gaussian encode gave {sorted(reg)}")
    if frozen:
        result["vf_trunk"] = _vf_trunk(engine, x, counters)
        result["vf_trunk"]["share_of_ae_step"] = result["vf_trunk"]["ms"] / ae_mean
    if spec.get("grad_check"):
        result["bf16_vs_fp32_grad"] = train_grad_check(path, engine, builder, state, gen)
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del builder, engine
    torch.cuda.empty_cache()
    if spec.get("entry_point"):
        result["entry_point"] = _train_entry_point(path)
    return result


def _train_entry_point(path: str) -> dict:
    """The training entry point, ``main(argv)``, on the config with the
    overlay for 2 steps (ae, then disc) on a temporary folder of seeded
    images: each step's launches those of the phase's pair, every logged
    value finite, and for vf the vf loss logged."""
    import contextlib
    import math
    import shutil
    import tempfile

    import torch
    from vqvae_from_gaussian_vae_tpu_torch import main as port_main

    spec = REG_PATHS[path]
    counters = launch_counters()
    tmp = tempfile.mkdtemp(prefix="gvq_regularizer_")
    try:
        images = write_images(os.path.join(tmp, "images"), REG_ENTRY_IMAGES)
        argv = ["--base", *[os.path.join(ROOT, c) for c in spec["configs"]], "--name", path,
                "--max_steps", "2", f"data.params.train.params.root={images}",
                "model.params.loss_config.params.disc_start=1",
                *[f"model.params.encoder_config.params.{k}={v}"
                  for k, v in spec.get("overrides", {}).items()],
                "training.trainer.log_every_n_steps=1", "--seed", str(SEED), "--no-test",
                "--logdir", os.path.join(tmp, "logs")]
        for k in counters.values():  # the entry point's counts: 0 just before it
            k.launches = 0
        with StepLaunches(counters) as steps, contextlib.redirect_stdout(sys.stderr):
            trainer = port_main.main(argv)
        require(trainer.state.step == 2, f"{path} entry point: step {trainer.state.step}")
        launches = {kind: _expect_per_step(f"{path} entry point {kind} step", steps.steps[kind],
                                           spec["launches"][kind]) for kind in ("ae", "disc")}
        rows = _csv_rows(os.path.join(trainer.logdir, "metrics.csv"))
        values = {k: float(v) for r in rows for k, v in r.items()
                  if v not in ("", None) and k.startswith("train/")}
        require(all(math.isfinite(v) for v in values.values()),
                f"{path} entry point: logged values not finite: {values}")
        want = ["train/loss/total", "train/loss/disc"] + (
            ["train/loss/vf"] if path.endswith("_vf") else [])
        require(all(k in values for k in want), f"{path} entry point: logged {sorted(values)}")
        run = steps.runs[0]
        out = {"steps": 2, "launches_per_step": launches,
               "step_ms_each": [1e3 * t for t in run["step_seconds"]],
               "fit_seconds": run["fit_seconds"],
               "checkpoint_saves": [{"name": n, "bytes": b, "seconds": sec}
                                    for n, b, sec in run["saves"]],
               "logged": {k: values[k] for k in want}}
        del trainer
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check_tokens(path: str, engine, x) -> dict:
    """encode -> dequant(indices) against the clamped decode of the
    quantized latent (2e-2), the latent itself against the codebook lookup
    (one bf16 ulp: LFQ's and BSQ's straight-through sums round in z's
    dtype), and for VQ and GQ2 the card's indices against the plain search
    of the same latents, differing only at float64-proven near-ties."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import (
        argmax_blocked, score_operands, vq_score_operands, vq_search_plain)
    from vqvae_from_gaussian_vae_tpu_torch.quantization.gaussian import _split_posterior

    z, reg = engine.encode(x, return_reg_log=True)
    idx = reg["indices"]
    require(idx.dtype == torch.int32 and idx.shape[:3] == z.shape[:3],
            f"{path}: indices {tuple(idx.shape)} {idx.dtype}, z {tuple(z.shape)}")
    xhat = engine.dequant(idx)
    xrec = engine.module._clamp(engine.decode(z))
    deq_err = float((xrec.float() - xhat.float()).abs().max())
    require(deq_err <= FLASH_ATOL, f"{path}: dequant(indices) vs decode(zhat) differ by {deq_err}")
    with torch.no_grad():
        lat = engine.regularization.dequant(idx).float()
    lat_err = float(((lat - z.float()).abs() / lat.abs().clamp_min(1.0)).max())
    require(lat_err <= 2.0 ** -8, f"{path}: dequant latent vs zhat differ by {lat_err}")
    out = {"indices": list(idx.shape), "dequant_vs_decode_max_abs": deq_err,
           "latent_max_rel": lat_err}
    search = REG_PATHS[path].get("search")
    if search is None:
        return out
    reg_mod = engine.regularization
    zraw, _ = engine.encode(x, unregularized=True)
    got = idx.reshape(-1)
    if search == "vq":
        dim, cn = reg_mod.dim, reg_mod.codebook_num
        rows = zraw.float().reshape(-1, dim, cn).transpose(1, 2).reshape(-1, dim)
        e = reg_mod.embedding.weight.detach()
        ones = torch.ones_like(rows)
        formula = vq_search_plain(rows, e)
        kernel_form = argmax_blocked(*vq_score_operands(rows, e))
        out.update(
            vs_plain_mismatches=int((got != formula).sum()),
            vs_plain_max_near_tie_gap=near_tie_gap(got, formula, rows, ones, e, beta=0.0),
            vs_kernel_form_mismatches=int((got != kernel_form).sum()),
            vs_kernel_form_max_near_tie_gap=near_tie_gap(got, kernel_form, rows, ones, e,
                                                         beta=0.0))
    else:
        rows, _ = reg_mod._to_rows(zraw)
        mu, _, std = _split_posterior(rows, reg_mod.logvar_range)
        mu, std = mu.reshape(-1, reg_mod.dim), std.reshape(-1, reg_mod.dim)
        want = argmax_blocked(*score_operands(mu, std, reg_mod.codebook, reg_mod.beta))
        out.update(vs_plain_mismatches=int((got != want).sum()),
                   vs_plain_max_near_tie_gap=near_tie_gap(got, want, mu, std, reg_mod.codebook,
                                                          reg_mod.beta))
    return out


def _vf_trunk(engine, x, counters) -> dict:
    """The frozen DINOv2 trunk alone: its launches a forward (48 LayerNorm)
    and its host ms (one warm-up, then the mean of two)."""
    import torch

    trunk = engine.module.foundation
    grid = x.shape[1] // trunk.patch_size
    with torch.no_grad():
        feats, counts = counted(counters, lambda: trunk(x))
        launches = require_launches("vf trunk forward", counts, VF_TRUNK)
        require(tuple(feats.shape) == (x.shape[0], grid, grid, trunk.width)
                and bool(torch.isfinite(feats).all()), f"vf trunk features {tuple(feats.shape)}")
        ms = [_host_ms(lambda: trunk(x)) for _ in range(2)]
    rows = x.shape[0] * (grid * grid + 1)
    return {"launches_per_forward": launches, "ms": sum(ms) / 2, "ms_all": ms,
            "tokens": rows, "width": trunk.width, "layers": len(trunk.blocks),
            "layer_norm_fwd": _trunk_layer_norm(rows, trunk.width)}


def _trunk_layer_norm(rows: int, c: int) -> dict:
    """B6a at the trunk's float32 (rows, width): the kernel against its
    plain version (``LN_F32_REL``), each timed, beside its bound and
    ``F.layer_norm``."""
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = 2 * torch.randn((rows, c), generator=gen, device="cuda") + 0.5
    w = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    y_k, y_p = ln.layer_norm_cuda(x, w, bias), ln.layer_norm_plain(x, w, bias)
    err = float((y_k - y_p).abs().max())
    require(err <= LN_F32_REL * float(y_p.abs().max()),
            f"float32 LN at ({rows}, {c}): kernel vs plain {err}")
    nbytes, flops = 2 * 4 * x.numel() + 2 * 4 * c, 8.0 * x.numel()
    bnd, by = bound_ms(flops, nbytes, PEAK_FP32)
    return {"shape": f"x ({rows},{c}) float32", "max_abs_err": err,
            "kernel_ms": time_ms(lambda: ln.layer_norm_cuda(x, w, bias)),
            "plain_ms": time_ms(lambda: ln.layer_norm_plain(x, w, bias)),
            "library_ms": time_ms(lambda: F.layer_norm(x, (c,), w, bias, 1e-5)),
            "bound_ms": bnd, "bound_by": by}


def run_flash_head_major(gen, dtype: str = "bfloat16"):
    """The head-major op's flow: one training call (forward with z, then the
    backward) at ``FLASH_LEAN_FLOW`` through the public ``flash_attention``,
    in bf16 or float32, with its exact launches: one forward and one
    backward."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention_lean as fl

    b, h, lq, lk, d = FLASH_LEAN_FLOW
    torch.cuda.reset_peak_memory_stats()
    q, k, v, do = _lean_inputs(gen, b, h, lq, lk, d, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    blocks = lean_blocks(lq, lk)

    def call():
        for t in leaves:
            t.grad = None
        o = fl.flash_attention(*leaves, d ** -0.5, blocks)
        o.backward(do)
        return o

    path = "flash_head_major" if dtype == "bfloat16" else "flash_head_major_f32"
    o, counts = counted(launch_counters(), call)
    launches = require_launches(path, counts,
                                {"flash_attention_lean_fwd": 1, "flash_attention_lean_bwd": 1})
    require(o.shape == q.shape and o.dtype == q.dtype, f"o {tuple(o.shape)} {o.dtype}")
    require(all(t.grad.shape == t.shape and bool(torch.isfinite(t.grad.float()).all())
                for t in leaves), "head-major flash: a gradient is not finite")
    ref = fl.flash_attention_res_plain(q, k, v, d ** -0.5)[0]
    err = float((o.detach().float() - ref.float()).abs().max())
    bar = FLASH_ATOL if dtype == "bfloat16" else FLASH_F32_REL * float(ref.abs().max())
    require(err <= bar, f"head-major flash ({dtype}): o vs plain error {err}")
    del ref
    return {"phase": "op", "path": path, "shape": list(FLASH_LEAN_FLOW), "dtype": dtype,
            "launches_per_call": launches, "o_vs_plain_max_abs": err,
            "call_ms": time_ms(call, iters=10 if dtype == "bfloat16" else 3, warmup=1),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


# the flash labs' phase: per timed combo, a warm-up chain then 3 trials of 10
# chains (labs/_timing.py:best_ms), then the checked launch
LAB_CHAINS = 1 + 3 * 10


def run_flash_labs(gen):
    """The flash labs (B15-B17): every default combo of the three labs at
    their full shape (16, 1024, 12, 64) bf16 through the labs' own ``run``,
    with the launches counted; then each combo's checked output against the
    einsum reference (``max_err``) and against its plain version, except
    ``matonly`` (timed only: it divides by a row sum of raw scores).
    Returns (one line per combo, the kernels line's entries)."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.labs import _common as LC
    from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_bwd_variants as lb
    from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_fwd_tilings as lt
    from vqvae_from_gaussian_vae_tpu_torch.labs import exp_flash_variants as lv
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_lab as FL

    del gen  # the labs draw their own inputs, as the JAX labs do
    q, k, v = LC.lab_inputs(3)
    ref = LC.einsum_reference(q, k, v)
    state = lb.lab_state()
    q2, k2, v2, do, o, z = state
    grads = LC.einsum_grads(q2, k2, v2, do)
    tilings = lt.default_combos()

    def drive():
        return ([lv.run(var, dep, (q, k, v), ref) for var, dep in lv.DEFAULT_COMBOS]
                + [lt.run(*t, (q, k, v), ref) for t in tilings]
                + [lb.run(*c, state, None if c[3] else grads) for c in lb.DEFAULT_COMBOS])

    results, counts = counted(launch_counters(), drive)
    runnable = [t for t in tilings if lt.no_counterpart(*t) is None]
    n_ctrl = sum(c[3] for c in lb.DEFAULT_COMBOS)
    fwd_calls, bwd_calls = lv.LAYERS * LAB_CHAINS + 1, lb.LAYERS * LAB_CHAINS + 1
    launches = require_launches("flash_labs", counts, {
        "flash_variant": len(lv.DEFAULT_COMBOS) * fwd_calls,
        "flash_fwd_tiling": len(runnable) * fwd_calls,
        "flash_bwd_tiling": (len(lb.DEFAULT_COMBOS) - n_ctrl) * bwd_calls,
        "flash_bwd_control": n_ctrl * bwd_calls})

    # the plain versions, each once (timed), and the yardsticks
    plain_fwd = {var: FL.flash_variant_plain(q, k, v, var, LC.SCALE, LC.H)
                 for var, _ in lv.DEFAULT_COMBOS if var != "matonly"}
    plain_bwd = fa.flash_attention_bwd_plain(q2, k2, v2, o, z, do, LC.SCALE, LC.H)
    plain_ctrl = FL.flash_bwd_control_plain(q2, k2, v2, do, LC.H)
    plain_ms = {
        "fwd": time_ms(lambda: FL.flash_variant_plain(q, k, v, "base", LC.SCALE, LC.H),
                       iters=3, warmup=1),
        "bwd": time_ms(lambda: fa.flash_attention_bwd_plain(q2, k2, v2, o, z, do, LC.SCALE,
                                                            LC.H), iters=3, warmup=1),
        "ctrl": time_ms(lambda: FL.flash_bwd_control_plain(q2, k2, v2, do, LC.H), iters=3,
                        warmup=1)}
    sdpa = {"fwd": LC.sdpa_fwd_ms(q, k, v), "bwd": LC.sdpa_bwd_ms(q2, k2, v2, do)}

    def hgmma(kernel, args):
        return next((n for name, n in sass_hgmma().items()
                     if FL._template_args(name, kernel) == list(args)), 0)

    lines, best = [], {}
    for r in results:
        out = r.pop("out", None)
        line = {"phase": "flash_lab", **r}
        if "skipped" not in r:
            kernels = (FL.BWD_KERNELS if r["lab"] == "exp_flash_bwd_variants"
                       else (FL.FWD_KERNEL,))
            line["sass_hgmma"] = {k: hgmma(k, r["kernel_args"]) for k in kernels}
            require(all(line["sass_hgmma"].values()),
                    f"flash lab {r['combo']}: no HGMMA in {line['sass_hgmma']}")
            bwd = r["lab"] == "exp_flash_bwd_variants"
            control = r["combo"].endswith(":control")
            if r["lab"] == "exp_flash_variants":
                var = r["combo"].split(":")[0]
                plain = None if var == "matonly" else plain_fwd[var]
            elif r["lab"] == "exp_flash_fwd_tilings":
                plain = plain_fwd["base"]
            else:
                plain = plain_ctrl if control else plain_bwd
            if plain is None:
                line["plain_err"] = None
            elif bwd:
                line["plain_err"] = max(_rel(g, w) for g, w in zip(out, plain))
                require(line["plain_err"] <= FLASH_BWD_REL,
                        f"flash lab {r['combo']}: {line['plain_err']} of max |out| from plain")
            else:
                line["plain_err"] = float((out.float() - plain.float()).abs().max())
                require(line["plain_err"] <= FLASH_ATOL,
                        f"flash lab {r['combo']}: {line['plain_err']} from its plain version")
            if r["checked"]:
                require(r["max_err"] <= FLASH_ATOL,
                        f"flash lab {r['lab']} {r['combo']}: max_err {r['max_err']}")
            line["sdpa_us"] = 1e3 * sdpa["bwd" if bwd else "fwd"]
            best.setdefault(r["lab"] + (":control" if control else ""), []).append(line)
        del out
        lines.append(line)
    for reason in lb.jax_default_reasons():
        lines.append({"phase": "flash_lab", "lab": "exp_flash_bwd_variants",
                      "jax_default": reason})

    def entry(name, key, combo, source, replaces, counter, plain_key, sdpa_key):
        row = next(x for x in best[key] if x["combo"] == combo)
        errs = [x["plain_err"] for x in best[key] if x["plain_err"] is not None]
        return {"name": name, "route": "cuda",
                "source": f"vqvae_from_gaussian_vae_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[counter], "path": "flash_labs",
                "max_abs_err": max(errs), "ms": row["us_per_layer"] / 1e3,
                "plain_ms": plain_ms[plain_key], "bound_ms": row["bound_us"] / 1e3,
                "bound_by": row["bound_by"], "library_ms": sdpa[sdpa_key],
                "per": f"one launch (one lab layer) of {combo}; max_abs_err over the lab's "
                       "checked combos against their plain versions"}

    summary = [
        entry("flash_variant", "exp_flash_variants", "base:1", "flash_lab_fwd.cu",
              "scripts/exp_flash_variants.py:54", "flash_variant", "fwd", "fwd"),
        entry("flash_fwd_tiling", "exp_flash_fwd_tilings", "1:192:128", "flash_lab_fwd.cu",
              "scripts/exp_flash_fwd_tilings.py:32", "flash_fwd_tiling", "fwd", "fwd"),
        entry("flash_bwd_tiling", "exp_flash_bwd_variants", "128:64:3", "flash_lab_bwd.cu",
              "scripts/exp_flash_bwd_variants.py:103", "flash_bwd_tiling", "bwd", "bwd"),
        entry("flash_bwd_control", "exp_flash_bwd_variants:control", "128:64:3:control",
              "flash_lab_bwd.cu", "scripts/exp_flash_bwd_variants.py:49", "flash_bwd_control",
              "ctrl", "bwd")]
    del q, k, v, ref, state, q2, k2, v2, do, o, z, grads, plain_fwd, plain_bwd, plain_ctrl
    torch.cuda.empty_cache()
    return lines, summary


def run_ln_matmul_lab(gen):
    """The LN-prologue matmul lab (B18): every default combo of
    ``labs/exp_ln_matmul.py`` (the JAX lab's seven and the port's
    fused:128:2304) at its full shape, (16384, 768) @ (768, N), N = 2304 and
    3072, through the lab's own ``run``, with the launches counted; each
    checked output held to the JAX lab's reference and to its plain version
    within 1e-2 of max |reference|; each combo's line carries its kernel's
    grid, tiles, registers, spills and HGMMA count (the TMA + wgmma GEMM
    body).  Then each kernel alone at the port's row block (128) and N =
    2304 for the kernels line, beside its plain version and the library
    pair, and the fused call's statistics pass and GEMM alone.  Returns
    (one line per combo, the kernels
    line's entries)."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.labs import exp_ln_matmul as lab
    from vqvae_from_gaussian_vae_tpu_torch.ops import ln_matmul as LM
    from vqvae_from_gaussian_vae_tpu_torch.ops.layer_norm import layer_norm_cuda

    del gen  # the lab draws its own inputs, as the JAX lab does
    inputs = {n: lab.lab_inputs(n) for n in sorted({n for _, _, n in lab.DEFAULT_COMBOS})}
    refs = {n: LM.ln_matmul_plain(*args, lab.EPS) for n, args in inputs.items()}

    def drive():
        return [lab.run(v, bm, n, inputs[n], refs[n]) for v, bm, n in lab.DEFAULT_COMBOS]

    results, counts = counted(launch_counters(), drive)
    calls = lab.LAYERS * LAB_CHAINS + 1  # per combo: 12 sites a chain, then the checked site
    per_variant = {v: sum(c[0] == v for c in lab.DEFAULT_COMBOS) for v in lab.VARIANTS}
    launches = require_launches("ln_matmul_lab", counts, {
        "ln_matmul": per_variant["fused"] * calls, "matmul_bias": per_variant["pmm"] * calls,
        "layer_norm_fwd": (per_variant["xla"] + per_variant["pmm"]) * calls})

    plain = {(v, n): lab.plain_site(v, *inputs[n]) for v, _, n in lab.DEFAULT_COMBOS}
    xla_us = {n: 1e3 * time_ms(lambda s=lab.make_site("xla", 0, *args[1:]), x=args[0]: s(x))
              for n, args in inputs.items()}
    # the GEMM body's kernels: ln_matmul_kernel<true> (fused), <false> (pmm)
    body = {v: {"design": "tma_wgmma",
                **named_kernel_facts("ln_matmul.cu",
                                     f"16ln_matmul_kernelILb{int(v == 'fused')}E")}
            for v in ("fused", "pmm")}
    lines, errs = [], {"fused": [], "pmm": []}
    for r in results:
        out = r.pop("out")
        variant, _, n = r["combo"].split(":")
        r.update(body.get(variant, {}))
        bar = lab.REL_BAR * r["ref_max"]
        r["plain_err"] = float((out.float() - plain[(variant, int(n))].float()).abs().max())
        require(r["max_err"] <= bar, f"ln_matmul lab {r['combo']}: max_err {r['max_err']} > {bar}")
        require(r["plain_err"] <= bar,
                f"ln_matmul lab {r['combo']}: {r['plain_err']} from its plain version > {bar}")
        errs.get(variant, []).append(r["plain_err"])
        lines.append({"phase": "ln_matmul_lab", **r, "xla_pair_us": xla_us[int(n)]})
        del out

    # each kernel alone at the port's row block, N = 2304, and its yardsticks
    n = lab.PORT_COMBO[2]
    x, g, b, w, wb = inputs[n]
    y = layer_norm_cuda(x, g, b, lab.EPS)
    o = torch.empty((x.shape[0], n), dtype=torch.bfloat16, device=x.device)
    bm = lab.PORT_COMBO[1]
    times = {
        "ln_matmul": time_ms(lambda: LM.ln_matmul_cuda(x, g, b, w, wb, bm)),
        "matmul_bias": time_ms(lambda: LM.matmul_bias_cuda(y, w, wb, bm)),
        "ln_matmul_plain": time_ms(lambda: LM.ln_matmul_plain(x, g, b, w, wb), iters=3,
                                   warmup=1),
        "matmul_bias_plain": time_ms(lambda: LM.matmul_bias_plain(y, w, wb), iters=3, warmup=1),
        "ln_matmul_library": xla_us[n] / 1e3,
        "matmul_bias_library": time_ms(lambda: torch.add(torch.matmul(y, w), wb, out=o))}
    mm = torch.matmul(y, w)
    # the xla pair's pieces, and a copy of the product's bytes beside its bias add
    parts = {"layer_norm": time_ms(lambda: layer_norm_cuda(x, g, b, lab.EPS)),
             "matmul": time_ms(lambda: torch.matmul(y, w)),
             "bias_add": time_ms(lambda: torch.add(mm, wb, out=o)),
             "copy": time_ms(lambda: o.copy_(mm)),
             "feedback": time_ms(lambda: torch.add(x, mm[:, :x.shape[1]], alpha=1e-6))}
    # the fused call's two kernels alone: the statistics pass and the GEMM
    split = device_kernel_ms(lambda: LM.ln_matmul_cuda(x, g, b, w, wb, bm), 10)
    split = {("statistics" if "ln_stats" in k else "gemm"): v["ms"] for k, v in split.items()}
    lines.append({"phase": "ln_matmul_lab", "n": n, "xla_pair_parts_ms": parts,
                  "ln_matmul_device_ms": split})

    def entry(name, variant, replaces, library):
        bound, by = lab.C.bound_ms(*lab.flops_bytes(variant, n))
        return {"name": name, "route": "cuda",
                "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/ln_matmul.cu",
                "replaces": replaces, "launches": launches[name], "path": "ln_matmul_lab",
                "max_abs_err": max(errs[variant]), "ms": times[name],
                "plain_ms": times[f"{name}_plain"], "bound_ms": bound, "bound_by": by,
                "library_ms": times[f"{name}_library"], **body[variant],
                "tile": f"{LM.TILE_M}x{LM.TILE_N}x{LM.TILE_K}", "stages": LM.STAGES,
                **({"device_ms": split} if variant == "fused" else {}),
                "kernels_per_call": 2 if variant == "fused" else 1,
                "per": f"one launch at bm={bm}, (16384, 768) @ (768, {n})"
                       + ("; each counted launch runs two kernels, the row statistics "
                          "(ln_stats_kernel), then the GEMM" if variant == "fused" else "")
                       + f"; max_abs_err over the lab's {variant} combos against their plain "
                         "versions; library: " + library}

    summary = [
        entry("ln_matmul", "fused", "scripts/exp_ln_matmul.py:64",
              "the xla pair (the LN kernel, torch.matmul, one bias add)"),
        entry("matmul_bias", "pmm", "scripts/exp_ln_matmul.py:81",
              "torch.matmul and one bias add")]
    del inputs, refs, plain, x, g, b, w, wb, y, o, mm
    torch.cuda.empty_cache()
    return lines, summary


# the gates' checks: the sd3unet at 200x200 (downsample inputs 200, 100, 50:
# the fused op where h % 4 == 0; upsample inputs 25, 50, 100; AttnBlocks at
# 25x25 = 625 tokens, so no flash); the reduced-depth sd3unet ae step (one
# resblock a level: 1 + 2 AttnBlocks)
UNET_ODD_LAUNCHES = {"gq_argmax": 1, "downsample_conv3x3_gn": 2,
                     "upsample_nearest_conv3x3_gn": 1}
UNET_REDUCED = {"num_res_blocks": 1}
UNET_REDUCED_AE = {**UNET_AE, "flash_attention_res_fwd": 3, "flash_attention_bwd": 3}
CONV_BWD_ENV = {"GVQ_DOWNSAMPLE_BWD": "conv", "GVQ_UPSAMPLE_BWD": "conv"}
VIT_REDUCED = {"layers": 2}
VIT_REDUCED_LAUNCHES = {"gq_argmax": 1, "flash_attention_qkv_fwd": 4, "layer_norm_fwd": 6,
                        "layer_norm_add_fwd": 6}


def run_gate_unet_odd(gen):
    """sd3unet_gq_0.25 encode -> dequant at 200x200, bs=2, bf16: its
    AttnBlocks take the einsum path (no flash launch), the 200 and 100
    downsamples the fused kernel; held to a float32 engine."""
    import torch

    engine, _ = build_engine(PATHS["sd3unet"]["config"], "bfloat16")
    x = torch.rand((2, 200, 200, 3), generator=gen, device="cuda") * 2 - 1

    def step():
        zhat, reg = engine.encode(x, return_reg_log=True)
        return zhat, reg["indices"], engine.dequant(reg["indices"])

    (zhat, idx, xhat), counts = counted(launch_counters(), step)
    launches = require_launches("sd3unet at 200x200", counts, UNET_ODD_LAUNCHES)
    require(tuple(idx.shape) == (2, 25, 25, 1) and tuple(xhat.shape) == (2, 200, 200, 3),
            f"sd3unet at 200x200: indices {tuple(idx.shape)}, xhat {tuple(xhat.shape)}")
    require(bool(torch.isfinite(xhat.float()).all()), "sd3unet at 200x200: xhat not finite")
    ref_engine, _ = build_engine(PATHS["sd3unet"]["config"], "float32")
    enc_rel = rel_l2(engine.encode(x, unregularized=True)[0],
                     ref_engine.encode(x, unregularized=True)[0])
    dec_rel = rel_l2(engine.decode(zhat), ref_engine.decode(zhat))
    require(enc_rel <= 0.1 and dec_rel <= 0.1,
            f"sd3unet at 200x200, bf16 vs float32: encoder rel L2 {enc_rel}, decoder {dec_rel}")
    del ref_engine, engine
    torch.cuda.empty_cache()
    return {"phase": "gate", "check": "sd3unet_200px", "batch": 2, "resolution": 200,
            "launches_per_step": launches,
            "bf16_vs_fp32_rel_l2": {"encoder": enc_rel, "decoder": dec_rel}}


def run_gate_vit_disabled(gen):
    """A 2-layer bsqvit_gq_0.25 (full width) encode -> dequant, bs=16, bf16,
    with ``GVQ_DISABLE_FUSED_KERNELS=1``: no LayerNorm or flash launch, and
    the values of the kernel path within ``PATH_SWITCH_REL_L2``."""
    import torch

    engine, _ = build_engine(PATHS["bsqvit"]["config"], "bfloat16", VIT_REDUCED)
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    zhat, _ = engine.encode(x, return_reg_log=True)
    disabled = {"GVQ_DISABLE_FUSED_KERNELS": "1"}

    def step():
        _, reg = engine.encode(x, return_reg_log=True)
        return engine.dequant(reg["indices"])

    def values():
        return engine.encode(x, unregularized=True)[0], engine.decode(zhat)

    counters = launch_counters()
    _, on = counted(counters, step)
    _, off = with_env(disabled, lambda: counted(counters, step))
    (z_on, d_on), (z_off, d_off) = values(), with_env(disabled, values)
    launches_on = require_launches("bsqvit, 2 layers", on, VIT_REDUCED_LAUNCHES)
    launches_off = require_launches("bsqvit, 2 layers, kernels disabled", off, {"gq_argmax": 1})
    enc_rel, dec_rel = rel_l2(z_off, z_on), rel_l2(d_off, d_on)
    require(enc_rel <= PATH_SWITCH_REL_L2 and dec_rel <= PATH_SWITCH_REL_L2,
            f"bsqvit with the kernels disabled vs on: encoder rel L2 {enc_rel}, "
            f"decoder {dec_rel}")
    del engine
    torch.cuda.empty_cache()
    return {"phase": "gate", "check": "bsqvit_kernels_disabled", "overrides": VIT_REDUCED,
            "batch": BATCH, "launches_on": launches_on, "launches_disabled": launches_off,
            "disabled_vs_on_rel_l2": {"encoder": enc_rel, "decoder": dec_rel}}


def run_gate_conv_bwd(gen):
    """One reduced-depth sd3unet ae step's gradient (bs=2, bf16 overlay)
    with ``GVQ_DOWNSAMPLE_BWD=conv`` and ``GVQ_UPSAMPLE_BWD=conv``: no
    resample dgrad or wgrad launch, and the gradient within
    ``TRAIN_GRAD_REL_L2`` of the default step's."""
    import torch

    engine, builder, _ = build_trainer("sd3unet", "bfloat16", overrides=UNET_REDUCED)
    x = torch.rand((2, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    eps = torch.randn((2, 32 * 32, engine.encoder.z_channels), generator=gen, device="cuda")
    state = builder.init_state(SEED, {"img": x})
    state.step = engine.loss.disc_start + 10

    def grads():
        return builder.ae_grads(state, {"img": x}, True, eps=eps)[0]

    counters = launch_counters()
    g_kernels, on = counted(counters, grads)
    g_conv, conv = with_env(CONV_BWD_ENV, lambda: counted(counters, grads))
    launches_on = require_launches("sd3unet ae, reduced", on, UNET_REDUCED_AE)
    launches_conv = require_launches(
        "sd3unet ae, reduced, conv-form resample backward", conv,
        {k: n for k, n in UNET_REDUCED_AE.items() if not k.endswith(("_dgrad", "_wgrad"))})
    total = rel_l2(torch.cat([g_conv[k].flatten() for k in g_kernels]),
                   torch.cat([g_kernels[k].flatten() for k in g_kernels]))
    require(total <= TRAIN_GRAD_REL_L2,
            f"sd3unet ae gradient, conv-form vs kernel resample backward: rel L2 {total}")
    del builder, engine
    torch.cuda.empty_cache()
    return {"phase": "gate", "check": "sd3unet_conv_form_resample_bwd", "overrides": UNET_REDUCED,
            "env": CONV_BWD_ENV, "batch": 2, "launches_kernels": launches_on,
            "launches_conv_form": launches_conv, "conv_vs_kernels_grad_rel_l2": total}


# the trainer phase: the port's training entry point (``main.py``'s
# ``main(argv)``) on a folder of seeded images: sd3unet with the bf16 overlay
# at full width and depth, 4 steps with a validation and the image logger at
# its first steps, then a resume for 2 more; bsqvit with the overlay at full
# width and 2 layers, 4 steps.  The discriminator starts at step 2, so both
# phases and the adaptive weight run.
TRAINER_IMAGES = 64           # 320x288, half JPEG, half PNG
TRAINER_VIT_LAYERS = 2
TRAINER_DISC_START = 2


def vit_launches(layers: int) -> dict:
    """bsqvit's launches per step at ``layers`` layers a side: a flash call a
    block; LN: ln_pre, the first block's ln_1 and ln_post a side; LN-add:
    the other 2 layers - 1 norms a side."""
    fwd = {"layer_norm_fwd": 6, "layer_norm_add_fwd": 2 * (2 * layers - 1)}
    return {"ae": {"flash_attention_qkv_res_fwd": 2 * layers,
                   "flash_attention_qkv_bwd": 2 * layers, **fwd, "layer_norm_bwd": 6,
                   "layer_norm_add_bwd": 2 * (2 * layers - 1)},
            "disc": {"flash_attention_qkv_fwd": 2 * layers, **fwd},
            "eval": {"gq_argmax": 1, "flash_attention_qkv_fwd": 2 * layers, **fwd}}


def write_images(folder: str, n: int, seed: int = SEED) -> str:
    """n seeded 320x288 images, even ones JPEG and odd ones PNG: each
    passes through load_image's resize and center crop."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        # smooth gradients plus noise, so that JPEG's decoders have work
        yy, xx = np.mgrid[0:288, 0:320]
        base = np.stack([(xx * (i + 1)) % 256, (yy * 3 + 7 * i) % 256, (xx + yy) % 256], -1)
        arr = np.clip(base + rng.integers(-20, 20, base.shape), 0, 255).astype(np.uint8)
        ext = "jpg" if i % 2 == 0 else "png"
        Image.fromarray(arr).save(os.path.join(folder, f"img_{i:03d}.{ext}"))
    return folder


class StepLaunches:
    """What the trainer does while it is open, with ``TrainStepBuilder``'s
    step methods, ``Trainer.fit`` and ``Checkpointer._write`` wrapped: the
    counts of every kernel in each ae, disc and eval step (``steps``), and
    for each ``fit`` call (``runs``) its wall seconds, CUDA events around
    each ae and disc step (read after the fit, so that no step waits for the
    card), and (name, bytes, seconds) of each checkpoint write."""

    def __init__(self, counters):
        self.counters = counters
        self.steps = {"ae": [], "disc": [], "eval": []}
        self.runs = []

    def __enter__(self):
        from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder
        from vqvae_from_gaussian_vae_tpu_torch.parallel.trainer import Checkpointer, Trainer

        self.saved = [(TrainStepBuilder, f"{k}_step") for k in self.steps]
        self.saved += [(Trainer, "fit"), (Checkpointer, "_write")]
        self.saved = [(cls, name, getattr(cls, name)) for cls, name in self.saved]
        for cls, name, fn in self.saved:
            setattr(cls, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        import torch

        def step(builder, *args, **kwargs):
            kind = name[:-len("_step")]
            before = {n: k.launches for n, k in self.counters.items()}
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = fn(builder, *args, **kwargs)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if kind != "eval":
                self.runs[-1]["events"].append((begin, end))
            self.steps[kind].append({n: k.launches - before[n]
                                     for n, k in self.counters.items()
                                     if k.launches != before[n]})
            return out

        def fit(trainer, *args, **kwargs):
            run = {"events": [], "saves": []}
            self.runs.append(run)
            t0 = time.perf_counter()
            out = fn(trainer, *args, **kwargs)
            torch.cuda.synchronize()
            run["fit_seconds"] = time.perf_counter() - t0
            run["step_seconds"] = [a.elapsed_time(b) / 1e3 for a, b in run.pop("events")]
            return out

        def write(ckpt, state, ckpt_name):
            t0 = time.perf_counter()
            fn(ckpt, state, ckpt_name)
            size = os.path.getsize(os.path.join(ckpt.dir, ckpt_name, "state.pt"))
            self.runs[-1]["saves"].append((ckpt_name, size, time.perf_counter() - t0))

        return {"fit": fit, "_write": write}.get(name, step)

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


def _same(a, b, where: str) -> int:
    """Require nested dicts and lists of tensors and numbers equal bit for
    bit; return the tensors compared."""
    import torch

    if torch.is_tensor(a):
        require(torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()), f"trainer resume: {where} differs")
        return 1
    if isinstance(a, dict):
        require(isinstance(b, dict) and set(a) == set(b), f"trainer resume: keys of {where}")
        return sum(_same(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        require(len(a) == len(b), f"trainer resume: length of {where}")
        return sum(_same(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    require(a == b, f"trainer resume: {where} {a} != {b}")
    return 0


class RestoreCheck:
    """Holds every tensor a resumed trainer restores to its checkpoint:
    ``Trainer.load_payload`` wrapped while it is open."""

    def __enter__(self):
        from vqvae_from_gaussian_vae_tpu_torch.parallel.trainer import Trainer

        self.saved = Trainer.load_payload
        self.restored = []
        check = self

        def load_payload(trainer, state, blob):
            state = check.saved(trainer, state, blob)
            now = trainer.checkpoint_payload(state)
            # the optimizers' restored states, as their state_dicts give them
            n = _same({k: blob[k] for k in now}, now, "state")
            check.restored.append({"step": state.step, "tensors": n})
            return state

        Trainer.load_payload = load_payload
        return self

    def __exit__(self, *exc):
        from vqvae_from_gaussian_vae_tpu_torch.parallel.trainer import Trainer

        Trainer.load_payload = self.saved


def _csv_rows(path: str):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _check_rows(label: str, rows, disc_start: int) -> dict:
    """Every logged number finite; the disc loss logged from disc_start on."""
    import math

    bad = [(r["step"], k) for r in rows for k, v in r.items()
           if v not in ("", None) and not math.isfinite(float(v))]
    require(not bad, f"{label}: logged values not finite: {bad[:5]}")
    disc = [int(r["step"]) for r in rows
            if r.get("train/loss/disc") not in ("", None) and int(r["step"]) >= disc_start]
    require(disc, f"{label}: no train/loss/disc logged from step {disc_start} on")
    ae = [r for r in rows if r.get("train/loss/total") not in ("", None)]
    require(any(float(r["train/scalars/d_weight"]) > 0 for r in ae
                if int(r["step"]) >= disc_start),
            f"{label}: the adaptive weight never ran")
    return {"rows": len(rows), "disc_steps": disc}


def _expect_per_step(label: str, steps, expected: dict) -> dict:
    want = {k: v for k, v in expected.items() if v}
    require(steps, f"{label}: no such step ran")
    for i, got in enumerate(steps):
        require(got == want, f"{label} {i}: launches {got} != {want}")
    return want


def _trainer_summary(trainer, run: dict, rows, steps_taken: int) -> dict:
    """One ``fit`` call: ``run`` is its record in ``StepLaunches.runs``."""
    import torch

    require(len(run["step_seconds"]) == steps_taken,
            f"trainer: {len(run['step_seconds'])} steps timed, not {steps_taken}")
    step_s = sum(run["step_seconds"])
    logged = [r for r in rows if r.get("imgs_per_sec")]  # training rows, not validation's
    return {"loader": trainer.data.loader_kind,
            "trainer_imgs_per_sec": float(logged[-1]["imgs_per_sec"]),
            "step_img_per_s": steps_taken * BATCH / step_s if step_s else None,
            "steps": steps_taken, "step_seconds": step_s,
            "step_ms_each": [1e3 * t for t in run["step_seconds"]],
            "fit_seconds": run["fit_seconds"],
            "outside_steps_share": 1.0 - step_s / run["fit_seconds"],
            "checkpoint_saves": [{"name": n, "bytes": b, "seconds": s}
                                 for n, b, s in run["saves"]],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_trainer(gen, train_results) -> dict:
    """The port's training entry point, in-process through ``main(argv)``,
    on a temporary folder of images that it deletes afterwards."""
    import shutil
    import tempfile

    import torch
    from vqvae_from_gaussian_vae_tpu_torch import main as port_main

    del gen  # the images come from SEED
    import contextlib

    def train(argv):  # the trainer's own prints go to stderr: stdout is one JSON line a phase
        with contextlib.redirect_stdout(sys.stderr):
            return port_main.main(argv)

    require(vit_launches(12) == TRAIN_PATHS["bsqvit"]["launches"],
            "vit_launches(12) disagrees with the bsqvit train phase's table")
    counters = launch_counters()
    tmp = tempfile.mkdtemp(prefix="gvq_trainer_")
    try:
        t0 = time.perf_counter()
        images = write_images(os.path.join(tmp, "images"), TRAINER_IMAGES)
        write_s = time.perf_counter() - t0
        common = [f"data.params.train.params.root={images}",
                  f"model.params.loss_config.params.disc_start={TRAINER_DISC_START}",
                  "training.trainer.log_every_n_steps=1", "--seed", str(SEED), "--no-test",
                  "--logdir", os.path.join(tmp, "logs")]
        val = {"target": "vqvae_from_gaussian_vae_tpu.data.dataset.SimpleDataset",
               "params": {"root": images, "image_size": RES}}
        # three writes of ~2.25 GB: step_00000004, best_step_00000004 and last
        unet = [f"data.params.validation={val!r}", "training.trainer.val_every_n_steps=3",
                "training.checkpoint.keep_every_n_train_steps=4",
                "training.checkpoint.monitor=val/loss/rec"]
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():  # the path's counts: 0 just before it
            k.launches = 0
        with StepLaunches(counters) as unet_steps:
            first = train(["--base", os.path.join(ROOT, TRAIN_PATHS["sd3unet"][
                "configs"][0]), os.path.join(ROOT, BF16_OVERLAY), "--name", "sd3unet",
                "--max_steps", "4", *common, *unet])
            logdir = first.logdir
            rows1 = _csv_rows(os.path.join(logdir, "metrics.csv"))
            summary1 = _trainer_summary(first, unet_steps.runs[0], rows1, 4)
            ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
            require({"last", "step_00000004", "best.json"} <= set(ckpts),
                    f"sd3unet trainer: checkpoints {ckpts}")
            images_logged = sorted(os.listdir(os.path.join(logdir, "images", "train")))
            require("reconstructions_gs-000000.png" in images_logged
                    and "vis_logits_gs-000002.png" in images_logged,
                    f"sd3unet trainer: images {images_logged}")
            require(any(r.get("val/loss/rec") for r in rows1), "sd3unet trainer: no validation")
            del first
            torch.cuda.empty_cache()
            with RestoreCheck() as restore:
                resumed = train(["--resume", logdir, "--max_steps", "6", "--seed",
                                          str(SEED), "--no-test"])
            require(restore.restored and restore.restored[0]["step"] == 4,
                    f"sd3unet trainer: resumed at {restore.restored}")
            rows2 = _csv_rows(os.path.join(logdir, "metrics.csv"))
            require([int(r["step"]) for r in rows2][0] == 4 and resumed.state.step == 6,
                    f"sd3unet trainer: the resumed run logged {[r['step'] for r in rows2]}")
            summary2 = _trainer_summary(resumed, unet_steps.runs[1], rows2, 2)
            del resumed
            torch.cuda.empty_cache()
        train_unet = train_results["sd3unet"]
        unet_counts = {kind: _expect_per_step(f"sd3unet trainer {kind} step",
                                              unet_steps.steps[kind],
                                              train_unet[f"launches_per_{kind}_step"])
                       for kind in ("ae", "disc", "eval")}
        unet_rows = _check_rows("sd3unet trainer", rows1 + rows2, TRAINER_DISC_START)
        unet_total = {n: k.launches for n, k in counters.items() if k.launches}
        for name in set().union(*unet_counts.values()):
            require(unet_total.get(name, 0) > 0, f"sd3unet trainer: {name} never launched")
        shutil.rmtree(os.path.join(tmp, "logs"), ignore_errors=True)

        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0
        layers = f"model.params.encoder_config.params.layers={TRAINER_VIT_LAYERS}"
        with StepLaunches(counters) as vit_steps:
            vit = train(["--base", os.path.join(ROOT, TRAIN_PATHS["bsqvit"]["configs"][0]),
                                  os.path.join(ROOT, BF16_OVERLAY), "--name", "bsqvit",
                                  "--max_steps", "4", *common, layers])
        vit_rows = _csv_rows(os.path.join(vit.logdir, "metrics.csv"))
        summary_vit = _trainer_summary(vit, vit_steps.runs[0], vit_rows, 4)
        require(os.path.exists(os.path.join(vit.logdir, "checkpoints", "last", "state.pt")),
                "bsqvit trainer: no checkpoints/last")
        del vit
        torch.cuda.empty_cache()
        expected_vit = vit_launches(TRAINER_VIT_LAYERS)
        vit_counts = {kind: _expect_per_step(f"bsqvit trainer {kind} step", vit_steps.steps[kind],
                                             expected_vit[kind]) for kind in ("ae", "disc")}
        _check_rows("bsqvit trainer", vit_rows, TRAINER_DISC_START)
        vit_total = {n: k.launches for n, k in counters.items() if k.launches}
        for name in set().union(*vit_counts.values(), expected_vit["eval"]):
            require(vit_total.get(name, 0) > 0, f"bsqvit trainer: {name} never launched")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "trainer", "entry_point": "vqvae_from_gaussian_vae_tpu_torch.main:main",
            "images": TRAINER_IMAGES, "image_write_s": write_s, "batch": BATCH,
            "resolution": RES, "disc_start": TRAINER_DISC_START,
            "sd3unet": {"configs": TRAIN_PATHS["sd3unet"]["configs"], "steps": "4 + resume 2",
                        "first": summary1, "resumed": summary2,
                        "restored_tensors": restore.restored[0]["tensors"],
                        "launches_per_step": unet_counts, "launches_total": unet_total,
                        "bare_pair_img_per_s": train_unet["pair_img_per_s"], **unet_rows},
            "bsqvit": {"configs": TRAIN_PATHS["bsqvit"]["configs"], "layers": TRAINER_VIT_LAYERS,
                       "steps": 4, "run": summary_vit, "launches_per_step": vit_counts,
                       "launches_total": vit_total,
                       "bare_pair_img_per_s_12_layers": train_results["bsqvit"]["pair_img_per_s"]}}


# ---------------------------------------------------------------------------
# the data-parallel phases: the training entry point and the evaluation sweep
# under one ``torchrun --nproc_per_node 2``: this file's ``--ddp-worker``
# mode wraps the training entry point to count and time what each rank does
# and calls it, then the evaluation entry point the same way
# (``eval_worker``) in the same ranks.  Two cards give NCCL, a card a
# rank; one card gives gloo, both ranks on card 0.

DDP_RANKS = 2
DDP_BATCH = BATCH // DDP_RANKS  # per rank: a step's joined batch is the trainer phase's
DDP_STEPS = 4
DDP_VAL_EVERY = 3
EVAL_METRIC_REL = 1e-4  # one rank against two: the same images, rows in another order
EVAL_FID_REL = 1e-3
EVAL_LAUNCHES = PATHS["sd3unet"]["launches"]  # a batch: the inference path's step


def torchrun(out_dir: str, eval_dir: str, argv, timeout: float = 600.0) -> None:
    """This file's ``--ddp-worker`` mode on DDP_RANKS ranks under torchrun:
    the training entry point on ``argv``, then the evaluation entry point on
    the arguments in ``eval_dir``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DDP_RANKS), os.path.join(ROOT, "chip_smoke.py"), "--ddp-worker", out_dir,
           eval_dir, "--", *argv]
    proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    with open(os.path.join(out_dir, "torchrun.log"), "w") as f:
        f.write(proc.stdout)
    sys.stderr.write(proc.stdout[-4000:])
    require(proc.returncode == 0, f"torchrun --ddp-worker exited {proc.returncode}: "
            f"{proc.stdout[-2000:]}")


def _rank_outputs(out_dir: str, kind: str):
    outs = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out_dir, f"{kind}_rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def _digest(tree) -> str:
    """sha256 over the bytes of every tensor in a nested payload, in key order."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(node):
        if torch.is_tensor(node):
            h.update(node.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy())
        elif isinstance(node, dict):
            for k in sorted(node, key=str):
                h.update(str(k).encode())
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            h.update(repr(node).encode())

    walk(tree)
    return h.hexdigest()


class _Patched:
    """Attributes replaced while open, restored after."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name)) for obj, name, _ in self.triples]
        for obj, name, new in self.triples:
            setattr(obj, name, new)
        return self

    def __exit__(self, *exc):
        for obj, name, old in self.saved:
            setattr(obj, name, old)


def ddp_worker(out_dir: str, argv) -> None:
    """One rank of the ddp phase: the port's ``main(argv)`` with its steps,
    the gradient all-reduces and the first ae step's update watched; then
    the state's digest, and on rank 0 the first ae step's gradient again in
    one process on the joined batch.  The process group stays up for the
    evaluation entry point that follows in the same ranks (a group made again
    after ``destroy_process_group`` takes the first one's name, and its
    rendezvous could read the first one's keys)."""
    import numpy as np
    import torch
    from vqvae_from_gaussian_vae_tpu_torch import main as port_main
    from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed
    from vqvae_from_gaussian_vae_tpu_torch.parallel import train_step as ts
    from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import TrainState

    counters = launch_counters()
    steps = {"ae": [], "disc": [], "eval": []}
    events, reduces, first, phase = [], [], {}, [None]
    step_fns = {k: getattr(ts.TrainStepBuilder, f"{k}_step") for k in steps}
    reduce_fn, apply_fn = distributed.all_reduce_mean_, ts._apply

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wrap(kind):
        def step(builder, state, batch, *args, **kwargs):
            if kind == "ae" and not first:
                first["joined"] = distributed.all_gather_rows(np.asarray(batch["img"]))
                if distributed.rank() == 0:  # the state the step starts from
                    eng = builder.engine
                    first.update(
                        engine={k: v.clone() for k, v in eng.module.state_dict().items()},
                        loss={k: v.clone() for k, v in eng.loss.state_dict().items()},
                        duals={k: v.clone() for k, v in state.duals.items()},
                        generator=state.generator.get_state(), step=state.step,
                        disc_active=args[0] if args else kwargs["disc_active"])
            before = {n: k.launches for n, k in counters.items()}
            phase[0] = kind
            begin = event()
            out = step_fns[kind](builder, state, batch, *args, **kwargs)
            end = event()
            phase[0] = None
            steps[kind].append({n: k.launches - before[n] for n, k in counters.items()
                                if k.launches != before[n]})
            if kind != "eval":
                events.append((kind, begin, end))
            return out
        return step

    def timed_reduce(tensors, dtype=None):
        tensors = list(tensors)
        nbytes = sum(t.numel() * (torch.empty((), dtype=dtype).element_size() if dtype
                                  else t.element_size()) for t in tensors)
        begin = event()
        reduce_fn(tensors, dtype=dtype)
        reduces.append((phase[0], nbytes, begin, event()))

    def apply(opt, named, grads):
        if "grads" not in first and phase[0] == "ae" and distributed.rank() == 0:
            first["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        apply_fn(opt, named, grads)

    patches = [(ts.TrainStepBuilder, f"{k}_step", wrap(k)) for k in steps]
    patches += [(distributed, "all_reduce_mean_", timed_reduce), (ts, "_apply", apply),
                (distributed, "shutdown", lambda: None)]
    t0 = time.perf_counter()
    with _Patched(*patches):
        trainer = port_main.main(argv)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rank, state = distributed.rank(), trainer.state
    payload = trainer.checkpoint_payload(state)
    out = {"rank": rank, "world": distributed.world(), "backend": distributed.backend(),
           "device": str(trainer.engine.device),
           "card": torch.cuda.get_device_name(trainer.engine.device),
           "steps": steps, "main_seconds": fit_s,
           "step_ms": [[k, b.elapsed_time(e)] for k, b, e in events],
           "reduces": [[p, n, b.elapsed_time(e)] for p, n, b, e in reduces],
           "digests": {k: _digest(payload[k]) for k in sorted(payload)},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del payload
    torch.cuda.empty_cache()
    if rank == 0:
        out["grad_check"] = _one_process_grad(trainer, first, TrainState)
    with open(os.path.join(out_dir, f"ddp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier()


def _one_process_grad(trainer, first, train_state_cls) -> dict:
    """The first ae step's all-reduced gradient against one process's on
    the joined batch, from the same weights, duals and generator state (so
    the same eps); the bars of the bf16 gradient check, zero-gradient
    tensors apart."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder

    engine = trainer.engine
    engine.module.load_state_dict(first["engine"])
    engine.loss.load_state_dict(first["loss"])
    generator = torch.Generator(device=engine.device)
    generator.set_state(first["generator"])
    state = train_state_cls(step=first["step"], duals=first["duals"], generator=generator,
                            ae_opt=trainer.state.ae_opt, disc_opt=trainer.state.disc_opt)
    one = TrainStepBuilder(engine, trainer.builder.ae_opt_spec, trainer.builder.disc_opt_spec,
                           mesh={"data": 1})
    want, _, _ = one.ae_grads(state, {"img": first["joined"]}, first["disc_active"])
    got = first["grads"]
    whole = float(torch.cat([g.flatten() for g in want.values()]).double().norm())
    zero = {k: [float(got[k].double().norm()), float(want[k].double().norm())]
            for k in want if float(want[k].double().norm()) < ZERO_GRAD_REL * whole}
    per = {k: rel_l2(got[k], want[k]) for k in want if k not in zero}
    worst = max(per, key=per.get)
    total = rel_l2(torch.cat([got[k].flatten() for k in want]),
                   torch.cat([want[k].flatten() for k in want]))
    top = sorted(per, key=per.get, reverse=True)[:5]
    return {"joined_batch": len(first["joined"]), "disc_active": first["disc_active"],
            "rel_l2_all": total, "worst_tensor": worst, "worst_rel_l2": per[worst],
            "next_worst": {k: per[k] for k in top[1:]}, "zero_gradient_tensors": zero}


def _seeded_metric_weights(folder: str):
    """(Inception, LPIPS) weight files: seeded port ``state_dict``s."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.evaluations import inception, lpips_metric

    net = inception.InceptionV3()
    inception.seed_weights(net, 5)
    lp = lpips_metric.LPIPSAlex()
    lpips_metric.seed_weights(lp, 3)
    with torch.no_grad():  # positive heads, as trained ones are
        for k in range(len(lpips_metric.CHNS)):
            getattr(lp, f"lin{k}").model[1].weight.abs_()
    paths = os.path.join(folder, "pt_inception.pth"), os.path.join(folder, "alex.pth")
    torch.save(net.state_dict(), paths[0])
    torch.save(lp.state_dict(), paths[1])
    return paths


def eval_worker(out_dir: str, argv) -> int:
    """The port's eval ``main(argv)`` with the engine's encode and decode
    and the metric nets timed (CUDA events), each encoded image's indices
    and pre-quantization latent kept by a hash of its pixels, and the
    kernels counted."""
    import hashlib

    import numpy as np
    import torch
    from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
    from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import AutoencodingEngine
    from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed
    from vqvae_from_gaussian_vae_tpu_torch.quantization.gaussian import GaussianQuantRegularizer

    counters = launch_counters()
    for k in counters.values():  # the path's counts: 0 just before it
        k.launches = 0
    spans = {"tokenizer": [], "metrics": []}
    latents, rows = [], {}
    encode, decode = AutoencodingEngine.encode, AutoencodingEngine.decode
    metrics_of, regularize = port_eval.metrics_of, GaussianQuantRegularizer.forward

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed(kind, fn):
        def call(*args, **kwargs):
            begin = event()
            out = fn(*args, **kwargs)
            spans[kind].append((begin, event()))
            return out
        return call

    def keep_latent(reg, z, *args, **kwargs):
        latents.append(z.detach().float().cpu())
        return regularize(reg, z, *args, **kwargs)

    def encode_kept(engine, x, *args, **kwargs):
        z, info = timed("tokenizer", encode)(engine, x, *args, **kwargs)
        pixels = x.detach().cpu().numpy()
        for i, idx in enumerate(info["indices"].cpu().numpy()):
            rows[hashlib.sha1(pixels[i].tobytes()).hexdigest()] = (idx, latents[-1][i].numpy())
        return z, info

    t0 = time.perf_counter()
    with _Patched((AutoencodingEngine, "encode", encode_kept),
                  (AutoencodingEngine, "decode", timed("tokenizer", decode)),
                  (port_eval, "metrics_of", timed("metrics", metrics_of)),
                  (GaussianQuantRegularizer, "forward", keep_latent)):
        result = port_eval.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    rank = distributed.rank()
    batches = len(spans["metrics"])
    tok = spans["tokenizer"]  # encode, decode: two a batch
    per_batch = [[tok[2 * i][0].elapsed_time(tok[2 * i][1])
                  + tok[2 * i + 1][0].elapsed_time(tok[2 * i + 1][1]),
                  spans["metrics"][i][0].elapsed_time(spans["metrics"][i][1])]
                 for i in range(batches)]
    out = {"rank": rank, "world": distributed.world(), "backend": distributed.backend(),
           "card": torch.cuda.get_device_name(), "batches": batches,
           "launches": {n: k.launches for n, k in counters.items() if k.launches},
           "batch_ms": per_batch,  # [tokenizer, metric nets] a batch
           "sweep_ms": tok[0][0].elapsed_time(spans["metrics"][-1][1]),
           "after_first_ms": (tok[2][0].elapsed_time(spans["metrics"][-1][1])
                              if batches > 1 else None),
           "main_seconds": main_s, "images": int(result["count"]), "my_images": len(rows)}
    if rank == 0:
        out.update({k: float(np.nanmean(result[k])) if len(result[k]) else None
                    for k in ("psnr", "ssim", "msssim", "lpips")})
        out.update(fid=result["fid"], usage=result.get("usage"), entropy=result.get("entropy"))
        np.save(os.path.join(out_dir, "hist.npy"), result["hist"])
    keys = sorted(rows)
    np.savez(os.path.join(out_dir, f"rows_rank{rank}.npz"), keys=np.array(keys),
             indices=np.stack([rows[k][0] for k in keys]),
             latents=np.stack([rows[k][1] for k in keys]))
    with open(os.path.join(out_dir, f"eval_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    return 0


def _eval_rows(out_dir: str, ranks: int):
    import numpy as np

    rows = {}
    for r in range(ranks):
        blob = np.load(os.path.join(out_dir, f"rows_rank{r}.npz"))
        for k, idx, lat in zip(blob["keys"], blob["indices"], blob["latents"]):
            rows[str(k)] = (idx, lat)
    return rows


def _compare_indices(one: dict, two: dict, config: str) -> dict:
    """Per image, one rank's indices and latent against two ranks'.  Where
    an index differs, each sweep's index must be the float64 best code of
    that sweep's own latent, within the near-tie bound of the GQ checks."""
    import numpy as np
    import torch
    from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import gq_scores_reference
    from vqvae_from_gaussian_vae_tpu_torch.quantization.common import to_tokens
    from vqvae_from_gaussian_vae_tpu_torch.quantization.gaussian import _split_posterior

    require(set(one) == set(two), "eval_sweep: the two sweeps saw different images")
    lat_rel = {k: float(np.linalg.norm(one[k][1] - two[k][1]) / np.linalg.norm(two[k][1]))
               for k in one}
    differ = [k for k in one if not (one[k][0] == two[k][0]).all()]
    result = {"images": len(one), "latents_bit_equal": sum(v == 0.0 for v in lat_rel.values()),
              "latent_rel_l2_max": max(lat_rel.values()),
              "images_with_a_differing_index": len(differ),
              "differing_indices": 0, "own_argmax_gap": 0.0}
    require(result["latent_rel_l2_max"] <= BF16_RTOL,
            f"eval_sweep: an image's latents differ by {result['latent_rel_l2_max']}")
    if differ:
        cfg = load_config(os.path.join(ROOT, config))
        reg = instantiate_from_config(cfg["model"]["params"]["regularizer_config"])
        codebook = reg.codebook.numpy()
        for k in differ:
            rows = np.nonzero(one[k][0].reshape(-1) != two[k][0].reshape(-1))[0]
            result["differing_indices"] += len(rows)
            for idx, lat in (one[k], two[k]):
                z, _ = to_tokens(torch.from_numpy(lat)[None], reg.format)
                mu, _, std = _split_posterior(z, reg.logvar_range)
                mu, std = reg.rows(mu).numpy(), reg.rows(std).numpy()
                for r in rows:
                    s = gq_scores_reference(mu[r:r + 1], std[r:r + 1], codebook)[0]
                    gap = float(s.max() - s[int(idx.reshape(-1)[r])])
                    require(gap <= NEAR_TIE * max(1.0, abs(float(s.max()))),
                            f"eval_sweep: index {int(idx.reshape(-1)[r])} of row {r} is not "
                            f"the best code of its latent (float64 gap {gap})")
                    result["own_argmax_gap"] = max(result["own_argmax_gap"], gap)
    return result


def run_ddp(images: str, tmp: str, train_results, eval_dir: str) -> dict:
    """The port's training entry point on DDP_RANKS ranks (``torchrun``), on
    the trainer phase's folder at DDP_BATCH images a rank; then, in the same
    ranks, the evaluation entry point on the arguments in ``eval_dir`` (the
    eval_sweep phase's two-rank run: one torchrun start for both)."""
    out_dir = os.path.join(tmp, "ddp")
    os.makedirs(out_dir)
    argv = ["--base", os.path.join(ROOT, TRAIN_PATHS["sd3unet"]["configs"][0]),
            os.path.join(ROOT, BF16_OVERLAY), "--name", "ddp", "--max_steps", str(DDP_STEPS),
            f"data.params.train.params.root={images}", f"data.params.batch_size={DDP_BATCH}",
            f"data.params.validation={{'target': "
            f"'vqvae_from_gaussian_vae_tpu.data.dataset.SimpleDataset', "
            f"'params': {{'root': {images!r}, 'image_size': {RES}}}}}",
            f"training.trainer.val_every_n_steps={DDP_VAL_EVERY}",
            f"model.params.loss_config.params.disc_start={TRAINER_DISC_START}",
            "training.trainer.log_every_n_steps=1", "--seed", str(SEED), "--no-test",
            "--logdir", os.path.join(tmp, "ddp_logs")]
    t0 = time.perf_counter()
    torchrun(out_dir, eval_dir, argv)
    wall = time.perf_counter() - t0
    ranks = _rank_outputs(out_dir, "ddp")
    require([r["rank"] for r in ranks] == list(range(DDP_RANKS)), "ddp: missing ranks")
    backend = ranks[0]["backend"]
    cards = sorted({r["device"] for r in ranks})
    import torch

    want = "nccl" if torch.cuda.device_count() >= DDP_RANKS else "gloo"
    require(backend == want and all(r["backend"] == backend for r in ranks),
            f"ddp: backend {[r['backend'] for r in ranks]}, not {want}")
    require(all(r["device"].startswith("cuda") for r in ranks), f"ddp: ranks on {cards}")
    require(len(cards) == (DDP_RANKS if want == "nccl" else 1), f"ddp: ranks on {cards}")
    digests = ranks[0]["digests"]
    differ = [k for k in digests if any(r["digests"][k] != digests[k] for r in ranks[1:])]
    require(not differ, f"ddp: the ranks' {differ} differ after {DDP_STEPS} steps")
    unet = train_results["sd3unet"]
    launches = [{kind: _expect_per_step(f"ddp rank {r['rank']} {kind} step", r["steps"][kind],
                                        unet[f"launches_per_{kind}_step"])
                 for kind in ("ae", "disc", "eval")} for r in ranks]
    g = ranks[0]["grad_check"]
    require(g["rel_l2_all"] <= TRAIN_GRAD_REL_L2 and g["worst_rel_l2"] <= TRAIN_GRAD_TENSOR_REL_L2,
            f"ddp: the first ae step's reduced gradient against one process's: {g}")
    step_ms = ranks[0]["step_ms"]
    per_phase = {}
    for kind in ("ae", "disc"):
        n = sum(1 for k, _ in step_ms if k == kind)
        rs = [(nb, ms) for p, nb, ms in ranks[0]["reduces"] if p == kind]
        per_phase[kind] = {"steps": n, "step_ms": [ms for k, ms in step_ms if k == kind],
                           "all_reduce_calls_per_step": len(rs) / n if n else None,
                           "all_reduce_bytes_per_step": sum(nb for nb, _ in rs) / n if n else None,
                           "all_reduce_ms_per_step": sum(ms for _, ms in rs) / n if n else None}
    step_s = sum(ms for _, ms in step_ms) / 1e3
    return {"phase": "ddp", "entry_point": "torchrun --nproc_per_node 2 "
            "vqvae_from_gaussian_vae_tpu_torch.main:main", "ranks": DDP_RANKS,
            "backend": backend, "cards": cards, "card_names": sorted({r["card"] for r in ranks}),
            "configs": TRAIN_PATHS["sd3unet"]["configs"], "batch_per_rank": DDP_BATCH,
            "joined_batch": DDP_BATCH * DDP_RANKS, "steps": DDP_STEPS,
            "disc_start": TRAINER_DISC_START, "state_digests_equal": len(digests),
            "launches_per_step": launches[0], "grad_vs_one_process": g,
            "joined_img_per_s": len(step_ms) * DDP_BATCH * DDP_RANKS / step_s,
            "per_phase": per_phase, "torchrun_seconds_with_the_two_rank_sweep": wall,
            "rank_main_seconds": [r["main_seconds"] for r in ranks],
            "peak_mem_gib": [r["peak_mem_gib"] for r in ranks]}


EVAL_CONFIG = "configs/sd3unet_gq_0.25.yaml"


def eval_sweep_argv(images: str, tmp: str):
    """(argv of the two-rank sweep on the folder, written to ``<tmp>/eval2``
    for the ddp ranks to run after their training; argv of the one-rank
    sweep on a ``.txt`` list of the folder's files in the order the ranks'
    shards cover them, so that each image sits in the same batch at the
    same position in both sweeps: cuDNN's bf16 3x3 conv gives the first and
    last image of a batch other bits when they change places,
    ``labs/batch_position_probe.py``)."""
    from vqvae_from_gaussian_vae_tpu_torch.data.dataset import SimpleDataset

    inc, lp = _seeded_metric_weights(tmp)
    files = SimpleDataset(images, RES).fpaths
    shard_order = os.path.join(tmp, "shard_order.txt")
    with open(shard_order, "w") as f:
        f.write("\n".join(p for r in range(DDP_RANKS) for p in files[r::DDP_RANKS]))
    argv = ["--base", os.path.join(ROOT, EVAL_CONFIG), "--img_size", str(RES), "--bs",
            str(BATCH), "--dtype", "bfloat16", "--inception_weights", inc, "--lpips_weights", lp]
    require(len(files) % (DDP_RANKS * BATCH) == 0, "eval_sweep: shards of whole batches")
    two = os.path.join(tmp, f"eval{DDP_RANKS}")
    os.makedirs(two)
    with open(os.path.join(two, "argv.json"), "w") as f:
        json.dump(argv + ["--dataset", images], f)
    return two, argv + ["--dataset", shard_order]


def run_eval_sweep(tmp: str, one_argv) -> dict:
    """The port's evaluation entry point on the same images in this process
    on one rank (``one_argv``), held to the two-rank sweep that the ddp
    phase's ranks ran after their training (``eval_sweep_argv``)."""
    import contextlib

    import numpy as np
    import torch

    config = EVAL_CONFIG
    runs = {}
    for n in (1, DDP_RANKS):
        out_dir = os.path.join(tmp, f"eval{n}")
        t0 = time.perf_counter()
        if n == 1:
            os.makedirs(out_dir)
            with contextlib.redirect_stdout(sys.stderr):
                eval_worker(out_dir, one_argv)
            outs = [json.load(open(os.path.join(out_dir, "eval_rank0.json")))]
        else:
            outs = _rank_outputs(out_dir, "eval")
        runs[n] = {"outs": outs, "wall": (time.perf_counter() - t0 if n == 1 else
                                          max(o["main_seconds"] for o in outs)),
                   "dir": out_dir, "hist": np.load(os.path.join(out_dir, "hist.npy"))}
        torch.cuda.empty_cache()
    one, two = runs[1]["outs"][0], runs[DDP_RANKS]["outs"]
    require(one["images"] == two[0]["images"] == TRAINER_IMAGES,
            f"eval_sweep: {one['images']} and {two[0]['images']} images")
    for out in [one] + two:
        per_batch = {k: v / out["batches"] for k, v in out["launches"].items()}
        require(per_batch == EVAL_LAUNCHES,
                f"eval_sweep rank {out['rank']} of {out['world']}: launches a batch {per_batch}")
    rows = {n: _eval_rows(runs[n]["dir"], n) for n in runs}
    for n in runs:  # each sweep's gathered histogram is its ranks' indices
        counts = np.bincount(np.concatenate([v[0].reshape(-1) for v in rows[n].values()]),
                             minlength=len(runs[n]["hist"]))
        require((counts == runs[n]["hist"]).all(),
                f"eval_sweep: the histogram of {n} rank(s) is not its ranks' indices")
    indices = _compare_indices(rows[1], rows[DDP_RANKS], config)
    hist_equal = bool((runs[1]["hist"] == runs[DDP_RANKS]["hist"]).all())
    require(hist_equal or indices["differing_indices"],
            "eval_sweep: the histograms differ, but no image's indices do")
    metrics = {}
    for k in ("psnr", "ssim", "msssim", "lpips", "fid"):
        a, b = one[k], two[0][k]
        metrics[k] = {"one_rank": a, "two_ranks": b, "rel": abs(a - b) / max(abs(b), 1e-12)}
    far = {k: m for k, m in metrics.items() if not (math.isfinite(m["one_rank"]) and m["rel"] <= (
        EVAL_FID_REL if k == "fid" else EVAL_METRIC_REL))}

    def timing(out):
        """img/s over the whole sweep and past its first batch (the warm-up:
        cuDNN's and the metric nets' first calls), and the tokenizer's share
        of the device time a batch past the first."""
        later = out["batch_ms"][1:]
        tok, met = sum(b[0] for b in later), sum(b[1] for b in later)
        return {"img_per_s": out["my_images"] / (out["sweep_ms"] / 1e3),
                "img_per_s_past_first_batch": (len(later) * BATCH / (out["after_first_ms"] / 1e3)
                                               if later else None),
                "tokenizer_share_past_first_batch": tok / (tok + met) if later else None,
                "batch_ms_tokenizer_metrics": out["batch_ms"], "sweep_ms": out["sweep_ms"],
                "main_seconds": out["main_seconds"]}

    line = {"phase": "eval_sweep", "entry_point": "vqvae_from_gaussian_vae_tpu_torch.eval:main",
            "config": config, "dtype": "bfloat16", "batch_per_rank": BATCH, "resolution": RES,
            "images": TRAINER_IMAGES, "metric_weights": "seeded (Inception, LPIPS alex)",
            "one_rank_dataset": "the folder's files as a .txt list in the ranks' shard order",
            "launches_per_batch": EVAL_LAUNCHES, "metrics": metrics,
            "usage": [one["usage"], two[0]["usage"]], "entropy": [one["entropy"],
                                                                   two[0]["entropy"]],
            "histograms_equal": hist_equal, "indices": indices,
            "backend": two[0]["backend"], "card_names": sorted({o["card"] for o in two}),
            "one_rank": timing(one), "two_ranks": [timing(o) for o in two],
            "two_ranks_joined_img_per_s": TRAINER_IMAGES / max(
                o["sweep_ms"] for o in two) * 1e3,
            "seconds": {n: runs[n]["wall"] for n in runs},  # ranks: their main's
            "metrics_off_their_bars": far}
    if far:
        emit(line)  # what was measured, then the failure
    require(not far, f"eval_sweep: one rank against {DDP_RANKS}: {far}")
    return line


def run_data_parallel(train_results):
    """The ddp and eval_sweep phases on a temporary folder of the trainer
    phase's images, which they delete afterwards."""
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="gvq_ddp_")
    try:
        images = write_images(os.path.join(tmp, "images"), TRAINER_IMAGES)
        torch.cuda.empty_cache()
        two_dir, one_argv = eval_sweep_argv(images, tmp)
        ddp = run_ddp(images, tmp, train_results, two_dir)
        emit(ddp)
        emit(run_eval_sweep(tmp, one_argv))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# serving, the post engine, the UNet's linear attention

# the serve phase: the port's daemon (``serve.py``) on sd3unet_gq_0.25 with
# its bf16 dotlist, in this process on 127.0.0.1; SERVE_CLIENTS clients each
# send rounds of /tokenize, /detokenize (of its own tokens) and /reconstruct
# (SERVE_COLD_ROUNDS on the cold daemon, then SERVE_ROUNDS).  A drained
# /tokenize bucket runs the encoder's kernels and the search, a /detokenize
# bucket the decoder's; /reconstruct is one of each.
SERVE_CONFIG = "configs/sd3unet_gq_0.25.yaml"
SERVE_BF16 = ["model.params.encoder_config.params.dtype=bfloat16"]
SERVE_MAX_BATCH = 8
SERVE_WINDOW_MS = 5.0
SERVE_CLIENTS = 16
SERVE_COLD_ROUNDS = 1
SERVE_ROUNDS = 4
SERVE_TOKENIZE = {"gq_argmax": 1, "downsample_conv3x3_gn": 3, "flash_attention_fwd": 2}
SERVE_DETOKENIZE = {"upsample_nearest_conv3x3_gn": 3, "flash_attention_fwd": 3}
# the probe's drains through the service's API, each held to the plain path:
# SERVE_PROBE requests at once (a bucket of 8), 3 (of 4) and 2, then each
# image alone (a bucket of 1); a batch window long enough that the
# requests released together drain as one batch
SERVE_PROBE = 5
SERVE_PROBE_DRAINS = (SERVE_PROBE, 3, 2)
SERVE_PROBE_WINDOW_S = 0.5


def _png_bytes(rgb) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return buf.getvalue()


def _serve_images(n: int, seed: int):
    """n seeded 256x256 RGB images (uint8): smooth gradients plus noise, so
    the latents are not all alike."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 1, RES, dtype=np.float32)
    out = []
    for _ in range(n):
        a, b, c = rng.uniform(0, 255, 3)
        base = a * ramp[None, :, None] + b * ramp[:, None, None] + c * 0.2
        img = base + rng.normal(0, 40, (RES, RES, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _percentile(values, q: float) -> float:
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(round(q / 100 * (len(vals) - 1))))]


def _pair_gaps(rows, first, second, mu, std, codebook):
    """For each row: (float64 score of code `first` - score of `second`, the
    near-tie bound) at the posterior (mu, std)."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import gq_scores_reference

    out = []
    for r in rows:
        s = gq_scores_reference(mu[r:r + 1].cpu().numpy(), std[r:r + 1].cpu().numpy(),
                                codebook[[int(first[r]), int(second[r])]].cpu().numpy())[0]
        out.append((float(s[0] - s[1]), NEAR_TIE * max(1.0, abs(float(s[1])))))
    return out


def _drain_together(service, kind: str, items) -> list:
    """`items` sent through the service's ``tokenize`` or ``detokenize``,
    one thread each, released together at a barrier inside a batch window
    of SERVE_PROBE_WINDOW_S; required: ``drained`` counts them as one batch.
    Their replies, in order."""
    import threading

    n = len(items)
    before = dict(service.drained[kind])
    barrier, out, errors = threading.Barrier(n), [None] * n, []
    call = getattr(service, kind)

    def send(i):
        barrier.wait()
        try:
            out[i] = call(items[i])
        except Exception as e:  # reported, and fails the phase
            errors.append(repr(e))

    window, service.window = service.window, SERVE_PROBE_WINDOW_S if n > 1 else 0.0
    try:
        threads = [threading.Thread(target=send, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        service.window = window
    require(not errors and all(o is not None for o in out), f"serve probe {kind}: {errors}")
    after = service.drained[kind]
    got = (after["batches"] - before["batches"], after["requests"] - before["requests"])
    require(got == (1, n), f"serve probe {kind}: {n} requests drained as (batches, requests) "
            f"{got}, not one batch")
    return out


def _serve_probe(service, images) -> dict:
    """The daemon's replies at each bucket size against the plain path at
    the same inputs.  /tokenize: drains of SERVE_PROBE_DRAINS requests and
    each image alone; every index of every reply against the plain blocked
    search (float32, TF32 off) at the latent of its padded batch (re-encoded
    here: the worker's batch, the last item repeated), each mismatch a
    float64 near-tie.  Bucket against solo: at each index where the bucket
    of 8's reply and the solo reply differ, the float64 score gap of the two
    codes at the bucket's latent and at the solo's; required: each reply's
    code scores at least as well at its own latent within the near-tie
    bound; reported: how many are near-ties at both latents, and the
    largest latent difference.  /detokenize: the bucket of 8's indices
    drained together, and the first alone, against ``dequant`` on the plain
    path (``GVQ_DISABLE_FUSED_KERNELS=1``) of the same padded batch, each
    image within PATH_SWITCH_REL_L2."""
    import numpy as np
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import argmax_blocked, score_operands
    from vqvae_from_gaussian_vae_tpu_torch.quantization.gaussian import _split_posterior

    engine, cap = service.engine, service.max_batch
    reg = engine.regularization
    bucket = service._bucket

    def padded(items):
        return items + [items[-1]] * (bucket(len(items), cap) - len(items))

    def tokenize(n, items):
        """(replies, latents, posterior rows, plain indices) of one drain."""
        replies = _drain_together(service, "tokenize", items)
        x = torch.from_numpy(np.stack(padded(items))).to(engine.device)
        z, _ = engine.encode(x, unregularized=True)
        mu, _, std = _split_posterior(z.reshape(z.shape[0], -1, z.shape[-1]), reg.logvar_range)
        mu, std = reg.rows(mu), reg.rows(std)
        plain = argmax_blocked(*score_operands(mu, std, reg.codebook, reg.beta))
        per = mu.shape[0] // z.shape[0]
        got = torch.from_numpy(np.stack(replies).reshape(-1)).to(plain)
        want = plain[:n * per]
        gap = near_tie_gap(got, want, mu[:n * per], std[:n * per], reg.codebook, reg.beta)
        return replies, z[:n], (mu[:n * per], std[:n * per]), per, {
            "requests": n, "bucket": bucket(n, cap), "indices": int(got.numel()),
            "mismatches_vs_plain": int((got != want).sum()), "max_near_tie_gap": gap}

    drains, bucket_out = [], None
    for n in SERVE_PROBE_DRAINS:
        out = tokenize(n, images[:n])
        drains.append(out[-1])
        if n == SERVE_PROBE:
            bucket_out = out
    solos = [tokenize(1, [img]) for img in images]
    solo_mis = sum(s[-1]["mismatches_vs_plain"] for s in solos)
    drains.append({"requests": 1, "bucket": 1, "images": len(solos),
                   "indices": sum(s[-1]["indices"] for s in solos),
                   "mismatches_vs_plain": solo_mis,
                   "max_near_tie_gap": max(s[-1]["max_near_tie_gap"] for s in solos)})

    b_replies, z_b, (mu_b, std_b), per, _ = bucket_out
    mismatched, z_diff = [], 0.0
    worst = {"bucket_latent": 0.0, "solo_latent": 0.0}
    for i, (s_replies, z_s, (mu_s, std_s), _, _) in enumerate(solos):
        z_diff = max(z_diff, float((z_b[i].float() - z_s[0].float()).abs().max()))
        got, want = b_replies[i].reshape(-1), s_replies[0].reshape(-1)
        rows = np.nonzero(got != want)[0].tolist()
        sl = slice(i * per, (i + 1) * per)
        at_b = _pair_gaps(rows, got, want, mu_b[sl], std_b[sl], reg.codebook)
        at_s = _pair_gaps(rows, want, got, mu_s, std_s, reg.codebook)
        for r, (gb, tb), (gs, ts) in zip(rows, at_b, at_s):
            require(gb >= -tb and gs >= -ts,
                    f"bucket-vs-solo image {i} row {r}: a reply is not its latent's code "
                    f"(gaps {gb} at the bucket's latent, {gs} at the solo's)")
            worst["bucket_latent"] = max(worst["bucket_latent"], gb)
            worst["solo_latent"] = max(worst["solo_latent"], gs)
            mismatched.append({"image": i, "row": r, "bucket_code": int(got[r]),
                               "solo_code": int(want[r]), "gap_at_bucket_latent": gb,
                               "gap_at_solo_latent": gs, "gap_change": gb + gs,
                               "near_tie": gb <= tb and gs <= ts})

    detok = []
    for idx in (list(b_replies), [b_replies[0]]):
        replies = _drain_together(service, "detokenize", idx)
        x = torch.from_numpy(np.stack(padded(idx))).to(engine.device)
        plain = with_env({"GVQ_DISABLE_FUSED_KERNELS": "1"}, lambda x=x: engine.dequant(x))
        plain = plain.float().cpu()
        rels = [rel_l2(torch.from_numpy(r), plain[i]) for i, r in enumerate(replies)]
        require(max(rels) <= PATH_SWITCH_REL_L2,
                f"serve probe /detokenize of {len(idx)} (bucket {bucket(len(idx), cap)}): "
                f"rel L2 {rels} against the plain path")
        detok.append({"requests": len(idx), "bucket": bucket(len(idx), cap),
                      "max_rel_l2_vs_plain": max(rels)})
    return {"tokenize_vs_plain": drains, "detokenize_vs_plain": detok,
            "bucket_vs_solo": {"requests": SERVE_PROBE, "bucket": bucket(SERVE_PROBE, cap),
                               "mismatches": len(mismatched),
                               "near_ties": sum(m["near_tie"] for m in mismatched),
                               "mismatched": mismatched[:16], "max_gap": worst,
                               "max_latent_abs_diff": z_diff}}


def _serve_load(url, pngs, service, counters, rounds: int) -> dict:
    """One load on the daemon: each of SERVE_CLIENTS threads sends `rounds`
    rounds of /tokenize, /detokenize of its reply and /reconstruct.
    Required: every reply 200 (no 5xx) and of its shape (the tokens' grid
    and range, a 256x256 RGB PNG), the worker alive, and the launches
    exactly those of the batches ``drained`` counts (`counters` set to 0
    before); the requests a second, p50 and p99 a route and the mean
    drained batch."""
    import io
    import json
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    reg = service.engine.regularization
    lat = {"tokenize": [], "detokenize": [], "reconstruct": []}
    codes, errors = [], []
    lock = threading.Lock()

    def request(route, body, kind):
        req = urllib.request.Request(f"{url}/{route}", data=body,
                                     headers={"Content-Type": kind})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                out, code = r.read(), r.status
        except urllib.error.HTTPError as e:
            out, code = e.read(), e.code
        with lock:
            lat[route].append(1e3 * (time.perf_counter() - t0))
            codes.append(code)
        return out, code

    def check_png(route, body):
        shape = np.asarray(Image.open(io.BytesIO(body))).shape
        require(shape == (RES, RES, 3), f"serve: /{route} gave an image of shape {shape}")

    def client(i):
        try:
            for _ in range(rounds):
                tok, code = request("tokenize", pngs[i], "image/png")
                if code == 200:
                    t = json.loads(tok)
                    require(t["shape"][:2] == [RES // 8, RES // 8] and
                            0 <= min(t["indices"]) and max(t["indices"]) < reg.n_samples,
                            f"serve: /tokenize gave shape {t['shape']}")
                    img, code = request("detokenize", tok, "application/json")
                    if code == 200:
                        check_png("detokenize", img)
                img, code = request("reconstruct", pngs[i], "image/png")
                if code == 200:
                    check_png("reconstruct", img)
        except Exception as e:  # a client that fails is reported, and fails the phase
            with lock:
                errors.append(repr(e))

    for k in counters.values():
        k.launches = 0
    before = {k: dict(v) for k, v in service.drained.items()}
    clients = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in counters.items()}
    require(not any(c.is_alive() for c in clients), "serve: a client did not finish")
    require(not errors, f"serve: client errors {errors[:3]}")
    fives = sum(1 for c in codes if c >= 500)
    require(fives == 0 and all(c == 200 for c in codes),
            f"serve: {fives} replies of 5xx, codes {sorted(set(codes))}")
    require(service.worker_alive(), "serve: the worker thread died")
    buckets = {k: service.drained[k]["batches"] - before[k]["batches"] for k in before}
    requests = sum(service.drained[k]["requests"] - before[k]["requests"] for k in before)
    expected = {n: buckets["tokenize"] * SERVE_TOKENIZE.get(n, 0)
                + buckets["detokenize"] * SERVE_DETOKENIZE.get(n, 0) for n in counts}
    launches = require_launches(f"serve ({buckets} buckets)", counts,
                                {n: v for n, v in expected.items() if v})
    return {"rounds": rounds, "requests": len(codes), "replies_5xx": fives,
            "worker_alive": True, "requests_per_s": len(codes) / wall, "wall_s": wall,
            "latency_ms": {r: {"n": len(v), "p50": _percentile(v, 50),
                               "p99": _percentile(v, 99)} for r, v in lat.items()},
            "drains": sum(buckets.values()),
            "mean_drained_batch": requests / sum(buckets.values()),
            "buckets": buckets, "launches": launches}


def run_serve(gen) -> dict:
    """The serving daemon through its HTTP surface, its worker thread making
    the process's first launches of the path's kernels (this phase runs
    before any other), then the probe of its replies against the plain
    path in bf16 and in float32 (TF32 off), and the bare engine's encode ->
    dequant at bs = 8."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from vqvae_from_gaussian_vae_tpu_torch import serve

    config = os.path.join(ROOT, SERVE_CONFIG)
    service, name = serve.build_service(config, image_size=RES, max_batch=SERVE_MAX_BATCH,
                                        batch_window_ms=SERVE_WINDOW_MS, overrides=SERVE_BF16,
                                        device="cuda")
    engine = service.engine
    require(engine.encoder.dtype == torch.bfloat16, "serve: the engine is not bf16")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service, name))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        require(health == {"status": "ok", "model": os.path.basename(config),
                           "devices": torch.cuda.device_count()}, f"serve: /healthz {health}")
        pngs = [_png_bytes(img) for img in _serve_images(SERVE_CLIENTS, SEED)]
        counters = launch_counters()
        result = {"phase": "serve", "config": SERVE_CONFIG, "overrides": SERVE_BF16,
                  "image_size": RES, "max_batch": SERVE_MAX_BATCH,
                  "batch_window_ms": SERVE_WINDOW_MS, "clients": SERVE_CLIENTS,
                  "healthz": health,
                  "launches_per_bucket": {"tokenize": SERVE_TOKENIZE,
                                          "detokenize": SERVE_DETOKENIZE},
                  # the first load makes the worker's first launches; the second is warm
                  "cold": _serve_load(url, pngs, service, counters, SERVE_COLD_ROUNDS),
                  "warm": _serve_load(url, pngs, service, counters, SERVE_ROUNDS)}
    finally:
        httpd.shutdown()
        httpd.server_close()
    probe = _serve_images(SERVE_PROBE, SEED + 1)
    arrays = [img.astype(np.float32) / 127.5 - 1.0 for img in probe]
    result["probe_bf16"] = _serve_probe(service, arrays)
    require(service.worker_alive(), "serve: the worker thread died")
    # the bare engine at the daemon's largest bucket: encode -> dequant, bs = 8
    x = torch.rand((SERVE_MAX_BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1

    def step():
        _, idx = engine.quant(x)
        return engine.dequant(idx)

    step()
    iters = 5
    ms = sum(_host_ms(step) for _ in range(iters)) / iters
    result["bare_engine_bs8"] = {"step_ms": ms, "img_per_s": SERVE_MAX_BATCH / (ms / 1e3)}
    del service, engine
    torch.cuda.empty_cache()
    fp32, _ = serve.build_service(config, image_size=RES, max_batch=SERVE_MAX_BATCH,
                                  batch_window_ms=SERVE_WINDOW_MS, device="cuda")
    result["probe_float32"] = _serve_probe(fp32, arrays)
    require(fp32.worker_alive(), "serve: the float32 worker thread died")
    del fp32
    torch.cuda.empty_cache()
    return result


# the post phase: the post engine on sd3unet_gq_0.25's autoencoder with the
# bf16 dotlist and create_hdit_model's defaults at bf16 (patch 4, widths
# 128, 256, depths 2, 4, heads 2, 4, windows 8, 0, mapping 256), bs = 16,
# 256x256, 50 Euler steps.  Only the four bottleneck blocks' global
# attention (L = 1024, four heads of 64) passes the flash gate; the level-0
# windows hold 64 tokens.
POST_STEPS = 50
POST_MID_BLOCKS = 4
HDIT_FLASH = (BATCH, 32 * 32, 4, 64)  # (B, L, heads, D) at the bottleneck
POST_LAUNCHES = {"flash_attention_fwd": POST_MID_BLOCKS * POST_STEPS}
POST_TRAIN = {"gq_argmax": 1, "downsample_conv3x3_gn": 3, "upsample_nearest_conv3x3_gn": 3,
              "flash_attention_fwd": 5, "flash_attention_res_fwd": POST_MID_BLOCKS,
              "flash_attention_bwd": POST_MID_BLOCKS}
POST_LR = 1e-4
# the post call's displacement x_50 - x_0, flash kernels against the einsum
# path (GVQ_DISABLE_FUSED_KERNELS=1) from the same start: bf16 rounds p
# at other places (PATH_SWITCH_REL_L2's reason), and 50 Euler steps add
# those per-step differences up without amplifying them
POST_SWITCH_REL_L2 = 2e-2
# the zero-initialised heads that would cut the attention off v: patch_out
# (v = 0) and attn_out (the attention's output times zero); seeded N(0, 1/fan_in)
POST_SEEDED_HEADS = ("patch_out.", "attn_out.")


def build_post_engine(dtype: str = "bfloat16"):
    from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config

    cfg = load_config(os.path.join(ROOT, SERVE_CONFIG), SERVE_BF16)
    p = cfg["model"]["params"]
    post = {"target": "vqvae_from_gaussian_vae_tpu.models.postprocessor.AutoencodingPostEngine",
            "params": {"encoder_config": p["encoder_config"],
                       "decoder_config": p["decoder_config"],
                       "regularizer_config": p["regularizer_config"],
                       "post_config": {"target":
                                       "vqvae_from_gaussian_vae_tpu.models.hdit.create_hdit_model",
                                       "params": {"dtype": dtype}},
                       "clamp_range": p.get("clamp_range", [-1.0, 1.0]),
                       "num_flow_steps": POST_STEPS}}
    engine = instantiate_from_config(post, seed=SEED, device="cuda")
    import torch

    gen = torch.Generator().manual_seed(SEED + 7)
    with torch.no_grad():
        for name, prm in engine.poster.named_parameters():
            if any(h in f".{name}" for h in POST_SEEDED_HEADS) and prm.dim() == 2:
                prm.copy_((torch.randn(prm.shape, generator=gen) * prm.shape[1] ** -0.5)
                          .to(prm.device))
    return engine


def check_flash_hdit(gen) -> list:
    """The unpacked token-major flash entries at HDiT's bottleneck, (16,
    1024, 4x64) bf16, on the D = 64 ``wgmma`` bodies (192-row q tiles of the
    forward: 1024 rows end in a ragged tile): the forward, the training
    forward with z and the backward, each against its plain version."""
    return [check_flash(gen, HDIT_FLASH, "flash_attention_fwd_hdit", "post",
                        POST_LAUNCHES["flash_attention_fwd"]),
            check_flash_res(gen, HDIT_FLASH, "flash_attention_res_fwd_hdit", "post_train_step",
                            POST_MID_BLOCKS),
            check_flash_bwd(gen, HDIT_FLASH, "flash_attention_bwd_hdit", "post_train_step",
                            POST_MID_BLOCKS)]


def _post_grads(engine, x, t, noise) -> dict:
    for p in engine.poster.parameters():
        p.grad = None
    engine.flow_loss(x, t=t, noise=noise).backward()
    return {n: p.grad.detach().clone() for n, p in engine.poster.named_parameters()
            if p.grad is not None}


def run_post(gen) -> dict:
    """The post engine through its own API at full width: a counted, timed
    ``post`` call (its 200 launches of the flash forward at HDiT's shape),
    held to the same call with the kernels disabled; two counted train steps
    (the frozen autoencoder's inference kernels, then the bottleneck's
    training forward and backward); the bf16 poster's gradient against a
    float32 poster's at bs = 2 (TF32 off)."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.models.hdit import create_hdit_model

    torch.cuda.reset_peak_memory_stats()
    engine = build_post_engine()
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    counters = launch_counters()
    xhat, idx_counts = counted(counters, lambda: engine.dequant(engine.quant(x)[1]))
    require_launches("post: the autoencoder's encode -> dequant", idx_counts,
                     PATHS["sd3unet"]["launches"])
    noise = torch.randn(xhat.shape, generator=gen, device="cuda")
    x0 = xhat.float() + noise * engine.mmse_noise_std
    out, counts = counted(counters, lambda: engine.post(xhat, noise=noise))
    launches = require_launches("post call", counts, POST_LAUNCHES)
    require(tuple(out.shape) == (BATCH, RES, RES, 3) and bool(torch.isfinite(out).all()),
            f"post: output {tuple(out.shape)} not finite")
    require(float(out.abs().max()) <= 1.0, "post: the clamp did not hold")
    post_ms = _host_ms(lambda: engine.post(xhat, noise=noise))
    plain = with_env({"GVQ_DISABLE_FUSED_KERNELS": "1"},
                     lambda: engine.post(xhat, noise=noise))
    moved = rel_l2(out - x0.clamp(-1, 1), plain - x0.clamp(-1, 1))
    require(moved <= POST_SWITCH_REL_L2,
            f"post: flash vs einsum displacement rel L2 {moved} > {POST_SWITCH_REL_L2}")
    disp = float((out - x0.clamp(-1, 1)).abs().mean())

    train_step, _ = engine.make_train_step(POST_LR)
    steps, step_launches = [], []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, c = counted(counters, lambda: train_step(x))
        steps.append({"ms": 1e3 * (time.perf_counter() - t0), "loss": float(loss)})
        step_launches.append(require_launches(f"post train step {i}", c, POST_TRAIN))
        require(math.isfinite(float(loss)), f"post train step {i}: loss {float(loss)}")

    xs, ts = x[:2], torch.rand((2,), generator=gen, device="cuda")
    ns = torch.randn((2, RES, RES, 3), generator=gen, device="cuda")
    g16 = _post_grads(engine, xs, ts, ns)
    ref = create_hdit_model(dtype="float32").cuda()
    ref.load_state_dict(engine.poster.state_dict())
    bf16_poster, engine.poster = engine.poster, ref
    try:
        g32 = _post_grads(engine, xs, ts, ns)
    finally:
        engine.poster = bf16_poster
    require(set(g16) == set(g32), "post: bf16 and float32 posters differ in their gradients")
    whole = float(torch.cat([g.flatten() for g in g32.values()]).double().norm())
    zero = {k: [float(g16[k].double().norm()), float(g32[k].double().norm())]
            for k in g32 if float(g32[k].double().norm()) < ZERO_GRAD_REL * whole}
    per = {k: rel_l2(g16[k], g32[k]) for k in g32 if k not in zero}
    worst = max(per, key=per.get)
    total = rel_l2(torch.cat([g16[k].flatten() for k in g32]),
                   torch.cat([g32[k].flatten() for k in g32]))
    require(total <= TRAIN_GRAD_REL_L2 and per[worst] <= TRAIN_GRAD_TENSOR_REL_L2,
            f"post: bf16 vs float32 poster gradient rel L2 {total} (worst {worst} {per[worst]})")
    del ref, engine
    torch.cuda.empty_cache()
    return {"phase": "post", "config": SERVE_CONFIG, "overrides": SERVE_BF16,
            "poster": "create_hdit_model defaults, dtype bfloat16",
            "seeded_heads": "patch_out and every block's attn_out seeded N(0, 1/fan_in) "
                            "(zero-initialised in the model: v = 0, the attention cut off)",
            "batch": BATCH, "resolution": RES, "num_flow_steps": POST_STEPS,
            "flash_shape": list(HDIT_FLASH), "launches_per_post": launches,
            "launches_per_train_step": step_launches[0], "post_ms": post_ms,
            "post_img_per_s": BATCH / (post_ms / 1e3),
            "flash_vs_einsum_displacement_rel_l2": moved,
            "tolerance": f"displacement rel L2 <= {POST_SWITCH_REL_L2}",
            "mean_abs_displacement": disp, "train_steps": steps,
            "bf16_vs_fp32_grad": {"batch": 2, "rel_l2_all": total, "worst_tensor": worst,
                                  "worst_rel_l2": per[worst], "zero_gradient_tensors": zero},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


# flux-dev at full width (hidden 3072, 24 heads of 128, 19 + 38 blocks,
# context 4096, vec 768) on a 256x256 image: 512 text tokens (flux-dev's T5
# length) and 16 x 16 image tokens
FLUX_TXT = 512
FLUX_FLASH = (1, FLUX_TXT + (RES // 16) ** 2, 24, 128)  # (B, L, heads, D): L = 768
FLUX_BLOCKS = 19 + 38  # row 4's launches a flux forward: every block's attention
CONTROLNET_BLOCKS = 2
FLUX_LAUNCHES = {"flash_attention_fwd": FLUX_BLOCKS}
FLUX_LORA_RANK = 128
FLUX_TIMED = 3  # timed forwards after the counted one
FLUX_REL_L2 = 2e-2  # the velocity, kernels on against off: bf16 rounds at other places
FLUX_DEQUANT_REL_L2 = 3e-2  # 2 Euler steps through both nets, then the FLUX VAE
FLUX_CHECK_STEPS = 2
FLUX_STEPS = 25  # AutoencodingFluxEngine's num_steps
FLUX_CFG_FROM = 5  # its timestep_to_start_cfg: the negative pass from step 5
FLUX_CLAMP = [-1.0, 1.0]  # the engine's clamp_range (the config sets none), as the post phase's


def flux_dequant_launches(steps: int) -> dict:
    """Row 4 and the upsample a dequant of one image launches: the
    ControlNet's 2 and flux's 57 a step, flux's 57 again from step 5 (the
    negative pass), the tokenizer decoder's 3 AttnBlocks and 3 upsamples."""
    unet = PATHS["sd3unet"]["launches"]
    cfg_steps = max(0, steps - FLUX_CFG_FROM)
    return {"flash_attention_fwd": steps * (CONTROLNET_BLOCKS + FLUX_BLOCKS)
            + cfg_steps * FLUX_BLOCKS + 3,
            "upsample_nearest_conv3x3_gn": unet["upsample_nearest_conv3x3_gn"]}


def reseed_zero_layers(module, seed: int) -> list:
    """Seed the layers the JAX init zeroes (``flux.ZERO_INIT``: the final
    projection, the ControlNet's output projections and last hint conv,
    LoRA's up) N(0, 1/fan_in): zero, they make the velocity exactly 0 and
    cut every attention off it."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.models.flux import ZERO_INIT

    gen = torch.Generator(device="cuda").manual_seed(seed)
    names = []
    with torch.no_grad():
        for name, p in module.named_parameters():
            if ZERO_INIT.search(name):
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
                names.append(name)
    return names


def build_flux(lora_rank: int = 0):
    """flux-dev built on the meta device, its storage on the card in bf16,
    seeded there by ``init_flux_weights``, the zero layers reseeded."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.models import flux as F

    model = F.build(F.Flux, F.flux_dev_params(), lora_rank=lora_rank, device="cuda")
    F.init_flux_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    return model, reseed_zero_layers(model, SEED + 1)


def flux_inputs(gen) -> dict:
    """One 256x256 image's latent noise as 256 tokens, 512 zero text tokens
    (no T5 weights here), a zero CLIP vector, t = 0.5, guidance 4."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.models import flux as F

    noise = F.get_noise(gen, 1, RES, RES, device="cuda")
    p = F.flux_dev_params()
    return {"img": F.pack_latents(noise).to(torch.bfloat16),
            "img_ids": F.make_img_ids(noise.shape[1], noise.shape[2], 1, device="cuda"),
            "txt": torch.zeros((1, FLUX_TXT, p.context_in_dim), dtype=torch.bfloat16,
                               device="cuda"),
            "txt_ids": torch.zeros((1, FLUX_TXT, 3), device="cuda"),
            "timesteps": torch.full((1,), 0.5, device="cuda"),
            "y": torch.zeros((1, p.vec_in_dim), dtype=torch.bfloat16, device="cuda"),
            "guidance": torch.full((1,), 4.0, device="cuda")}


def _with_bf16_qk(fn):
    """fn() with flux's attention rounding the rotated q and k to v's bf16
    before the einsum path, as the kernel path rounds them."""
    from vqvae_from_gaussian_vae_tpu_torch.models import flux as F
    from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import sdpa_token_major

    def attention(q, k, v, pe):
        qf, kf = F.apply_rope(q, k, pe)
        return sdpa_token_major(qf.to(v.dtype), kf.to(v.dtype), v)

    real, F.attention = F.attention, attention
    try:
        return fn()
    finally:
        F.attention = real


def _flux_attention_calls(model, kw) -> dict:
    """Each of one flux forward's attention calls against the einsum path on
    that call's own inputs (the rotated q and k rounded to bf16, as the
    kernel reads them), at row 4's entry bar (FLASH_ATOL).  The entry holds
    outputs of unit-variance inputs, under 1 in size, where the bar is many
    bf16 ulps; flux's outputs reach 4-8, where one bf16 ulp is 0.03125.
    So each call is held at the entry's scale: its v divided by the power of
    two at or above its output's largest magnitude, an exact scaling in bf16
    under which the attention, linear in v, and both paths' roundings scale
    exactly (the kernel's scaled output times that power is checked equal
    to its output).  The unscaled differences are reported beside."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.models import flux as F
    from vqvae_from_gaussian_vae_tpu_torch.ops.flash_attention import sdpa_token_major

    calls, real = [], F.attention

    def recording(q, k, v, pe):
        o = real(q, k, v, pe)
        calls.append((q, k, v, pe, o))
        return o

    def plain(fn):
        return with_env({"GVQ_DISABLE_FUSED_KERNELS": "1"}, fn)

    counters = launch_counters()
    with _Patched((F, "attention", recording)), torch.inference_mode():
        _, counts = counted(counters, lambda: model(**kw))
    require(len(calls) == FLUX_BLOCKS and counts.get("flash_attention_fwd") == FLUX_BLOCKS,
            f"flux: {len(calls)} attention calls, {counts} launches")
    rows = []
    with torch.inference_mode():
        for q, k, v, pe, o in calls:
            qf, kf = F.apply_rope(q, k, pe)
            qb, kb = qf.to(v.dtype), kf.to(v.dtype)
            got = sdpa_token_major(qb, kb, v)  # the call as the kernel reads it
            ref = plain(lambda: sdpa_token_major(qb, kb, v))
            scale = 2.0 ** math.ceil(math.log2(max(float(ref.abs().max()), 2.0 ** -60)))
            o_unit = sdpa_token_major(qb, kb, v / scale)
            ref_unit = plain(lambda: sdpa_token_major(qb, kb, v / scale))
            rows.append({"scale": scale,
                         "max_abs_at_unit_scale": float((o_unit.float() - ref_unit.float())
                                                        .abs().max()),
                         "max_abs": float((got.float() - ref.float()).abs().max()),
                         "scaled_exactly": bool(torch.equal(o_unit * scale, got)),
                         "same_as_the_forward": bool(torch.equal(got, o)),
                         "max_abs_vs_float32_qk": float(
                             (got.float() - plain(lambda: real(q, k, v, pe)).float()).abs().max())})
    del calls
    unit = [r["max_abs_at_unit_scale"] for r in rows]
    worst = max(range(len(unit)), key=unit.__getitem__)
    require(unit[worst] <= FLASH_ATOL,
            f"flux: attention call {worst} against the einsum at unit scale: {unit[worst]} > "
            f"{FLASH_ATOL}")
    require(all(r["scaled_exactly"] for r in rows),
            "flux: a call's kernel output does not scale exactly with v")
    require(all(r["same_as_the_forward"] for r in rows),
            "flux: a call's kernel output differs from the forward's")
    absolute = [r["max_abs"] for r in rows]
    return {"calls": len(rows), "tolerance": f"bf16 atol {FLASH_ATOL} (row 4's entry) on v "
            "scaled by a power of two to outputs within 1",
            "worst_call": worst, "worst_max_abs_at_unit_scale": unit[worst],
            "worst_max_abs_unscaled": max(absolute),
            "worst_call_unscaled": max(range(len(absolute)), key=absolute.__getitem__),
            "rows": rows}


def check_flash_flux(gen):
    """Row 4's entry at flux-dev's attention, (1, 768, 24x128) bf16, on the
    D = 128 ``wgmma`` body, against its plain version, SDPA beside it."""
    return check_flash(gen, FLUX_FLASH, "flash_attention_fwd_flux", "flux", FLUX_BLOCKS)


def run_flux(gen) -> dict:
    """One flux-dev forward through ``Flux.forward`` at full width, bs 1,
    256x256, 512 text tokens, bf16: its 57 launches of row 4's kernel, held
    to the same forward with the kernels disabled (the einsum attention);
    ms a forward, peak memory; then one forward with rank-128 LoRA deltas."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, reseeded = build_flux()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kw = flux_inputs(gen)
    counters = launch_counters()
    with torch.inference_mode():
        out, counts = counted(counters, lambda: model(**kw))
        launches = require_launches("flux forward", counts, FLUX_LAUNCHES)
        require(tuple(out.shape) == (1, (RES // 16) ** 2, 64) and bool(torch.isfinite(out).all()),
                f"flux: velocity {tuple(out.shape)} not finite")
        ms = [_host_ms(lambda: model(**kw)) for _ in range(FLUX_TIMED)]
        breakdown = profile_step(lambda: model(**kw))
        plain = with_env({"GVQ_DISABLE_FUSED_KERNELS": "1"}, lambda: model(**kw))
        plain_ms = _host_ms(lambda: with_env({"GVQ_DISABLE_FUSED_KERNELS": "1"},
                                             lambda: model(**kw)))
        plain_bf16_qk = with_env({"GVQ_DISABLE_FUSED_KERNELS": "1"},
                                 lambda: _with_bf16_qk(lambda: model(**kw)))
    per_call = _flux_attention_calls(model, kw)
    rel = rel_l2(out.float(), plain.float())
    # where the difference comes from: the kernel against the einsum path
    # with q and k rounded to bf16 as the kernel path rounds them, and that
    # rounding alone
    rel_parts = {"kernel_vs_einsum_bf16_qk": rel_l2(out.float(), plain_bf16_qk.float()),
                 "bf16_qk_rounding_alone": rel_l2(plain_bf16_qk.float(), plain.float())}
    require(rel <= FLUX_REL_L2, f"flux: flash vs einsum velocity rel L2 {rel} > {FLUX_REL_L2}")
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, out, plain, plain_bf16_qk
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    lora, lora_reseeded = build_flux(FLUX_LORA_RANK)
    with torch.inference_mode():
        out, lora_counts = counted(counters, lambda: lora(**kw))
        lora_launches = require_launches("flux forward, LoRA rank 128", lora_counts,
                                         FLUX_LAUNCHES)
        require(bool(torch.isfinite(out).all()), "flux LoRA: velocity not finite")
        lora_ms = [_host_ms(lambda: lora(**kw)) for _ in range(FLUX_TIMED)]
    lora_params = sum(p.numel() for p in lora.parameters())
    lora_peak = torch.cuda.max_memory_allocated() / 2**30
    del lora, out
    torch.cuda.empty_cache()
    return {"phase": "flux", "model": "flux-dev (FluxParams defaults), bf16",
            "parameters": n_params, "batch": 1, "resolution": RES, "text_tokens": FLUX_TXT,
            "flash_shape": list(FLUX_FLASH), "launches_per_forward": launches,
            "reseeded_zero_layers": len(reseeded),
            "seeded": "init_flux_weights on the card (generator seed 0); the JAX init's zero "
                      "layers reseeded N(0, 1/fan_in)",
            "build_s": build_s, "forward_ms": ms, "einsum_forward_ms": plain_ms,
            "flash_vs_einsum_rel_l2": rel, "tolerance": f"rel L2 <= {FLUX_REL_L2}",
            "rel_l2_parts": rel_parts, "attention_calls": per_call,
            "peak_mem_gib": peak, "profile": breakdown,
            "lora": {"rank": FLUX_LORA_RANK, "parameters": lora_params,
                     "reseeded_zero_layers": len(lora_reseeded), "launches": lora_launches,
                     "forward_ms": lora_ms, "peak_mem_gib": lora_peak}}


def run_flux_dequant(gen) -> dict:
    """``AutoencodingFluxEngine`` on sd3unet_gq_0.25's tokenizer in bf16 with
    the full pipeline (flux-dev, its depth-2 ControlNet, the FLUX VAE in
    float32) through ``quant`` and ``dequant``: 2 steps held to the same
    call with the kernels disabled (the latents the FLUX VAE decodes, and
    the image), then one timed 25-step ``dequant`` with its exact launches."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config
    from vqvae_from_gaussian_vae_tpu_torch.models import flux as F

    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(os.path.join(ROOT, SERVE_CONFIG), SERVE_BF16)
    cfg["model"]["target"] = ("vqvae_from_gaussian_vae_tpu.models.flux_pipeline."
                              "AutoencodingFluxEngine")
    cfg["model"]["params"]["loss_config"] = None
    cfg["model"]["params"]["clamp_range"] = FLUX_CLAMP
    engine = instantiate_from_config(cfg["model"], seed=SEED, device="cuda")
    t0 = time.perf_counter()
    engine.load_flux_pipeline()
    pipe = engine.xflux_pipeline
    reseeded = reseed_zero_layers(pipe.model, SEED + 1) + \
        reseed_zero_layers(pipe.controlnet, SEED + 2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = torch.rand((1, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    _, indices = engine.quant(x)
    noise = F.get_noise(gen, 1, RES, RES, device="cuda")
    latents = []
    ae_decode = pipe.ae.decode

    def recorded(z):
        latents.append(z.clone())
        return ae_decode(z)

    pipe.ae.decode = recorded
    counters = launch_counters()
    try:
        engine.num_steps = FLUX_CHECK_STEPS
        out2, c2 = counted(counters, lambda: engine.dequant(indices, noise=noise))
        check_launches = require_launches("flux_dequant, 2 steps", c2,
                                          flux_dequant_launches(FLUX_CHECK_STEPS))
        plain2 = with_env({"GVQ_DISABLE_FUSED_KERNELS": "1"},
                          lambda: engine.dequant(indices, noise=noise))
    finally:
        pipe.ae.decode = ae_decode
        engine.num_steps = FLUX_STEPS
    rel_latent = rel_l2(latents[0], latents[1])
    rel_image = rel_l2(out2, plain2)
    require(rel_latent <= FLUX_DEQUANT_REL_L2 and rel_image <= FLUX_DEQUANT_REL_L2,
            f"flux_dequant: kernels vs einsum rel L2 latent {rel_latent}, image {rel_image}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, counts = counted(counters, lambda: engine.dequant(indices, noise=noise))
    seconds = time.perf_counter() - t0
    launches = require_launches("flux_dequant, 25 steps", counts,
                                flux_dequant_launches(FLUX_STEPS))
    require(tuple(out.shape) == (1, RES, RES, 3) and bool(torch.isfinite(out).all()),
            f"flux_dequant: image {tuple(out.shape)} not finite")
    require(float(out.abs().max()) <= 1.0, "flux_dequant: the clamp did not hold")
    line = {"phase": "flux_dequant", "config": SERVE_CONFIG,
            "overrides": SERVE_BF16 + [f"model.params.clamp_range={FLUX_CLAMP}"],
            "engine": "AutoencodingFluxEngine (flux-dev, ControlNet depth 2, FLUX VAE float32)",
            "batch": 1, "resolution": RES, "indices": list(indices.shape),
            "reseeded_zero_layers": len(reseeded), "build_s": build_s,
            "check_steps": FLUX_CHECK_STEPS, "check_launches": check_launches,
            "kernels_vs_einsum_rel_l2": {"latent": rel_latent, "image": rel_image},
            "tolerance": f"rel L2 <= {FLUX_DEQUANT_REL_L2}", "steps": FLUX_STEPS,
            "cfg_from_step": FLUX_CFG_FROM, "negative_pass": "only on CFG steps",
            "launches_per_dequant": launches, "dequant_s": seconds,
            "clamped_share": float((out.abs() >= 1.0).float().mean()),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del engine, pipe, out, out2, plain2, latents
    torch.cuda.empty_cache()
    return line


# the frozen baselines at their published widths, float32, through the port's
# eval.py in protocol mode: its ``_engine`` and ``metrics_of`` (its ``main``
# adds FID, whose host sqrtm of 2048 x 2048 takes about 20 s a call; the
# CPU tests run ``main`` on a baseline, the eval_sweep phase on the card)
BASELINES = ("AutoencoderKLFLUX", "AutoencoderKLSD3", "AutoencoderKLEQ",
             "AutoencoderKLHYImage2", "AutoencoderKLHYImage3", "AutoencoderKLQwenImage",
             "AutoencoderKLWAN")
BASELINE_IMAGES = 12
BASELINE_BATCH = 4


def run_baselines(gen) -> dict:
    """Each baseline VAE built by the port's ``eval.py`` (``_engine``: a
    wrapper with no ``.module``) from a ``pit.models.autoencoder.*`` target,
    over seeded 256x256 images at bs 4: finite PSNR, SSIM and LPIPS (the
    sweep's ``metrics_of``, seeded Inception and LPIPS), img/s of encode ->
    decode past the first batch, peak memory.  The Qwen-Image and WAN
    wrappers run the WAN video VAE on one-frame clips."""
    import contextlib
    import tempfile

    import numpy as np
    import torch
    import yaml
    from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
    from vqvae_from_gaussian_vae_tpu_torch.data.dataset import SimpleDataset
    from vqvae_from_gaussian_vae_tpu_torch.evaluations import inception as inception_mod
    from vqvae_from_gaussian_vae_tpu_torch.evaluations.lpips_metric import LPIPSMetric

    tmp = tempfile.mkdtemp(prefix="gvq_baselines_")
    folder = write_images(os.path.join(tmp, "images"), BASELINE_IMAGES)
    data = SimpleDataset(folder, image_size=RES)
    images = torch.as_tensor(np.stack([data[i]["img"] for i in range(BASELINE_IMAGES)]),
                             device="cuda")
    inception = inception_mod.InceptionV3(output_blocks=(3,), resize_input=True,
                                          normalize_input=False)
    inception_mod.seed_weights(inception, 1)
    inception.to("cuda").eval()
    lpips = LPIPSMetric("alex", device=torch.device("cuda"))
    rows = {}
    for i, name in enumerate(BASELINES):
        base = os.path.join(tmp, f"{name}.yaml")
        with open(base, "w") as f:
            yaml.safe_dump({"model": {"target": f"pit.models.autoencoder.{name}",
                                      "params": {"seed": SEED + i}}}, f)
        args = port_eval.get_parser().parse_args(["--base", base, "--dataset", folder])
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(sys.stderr):  # its random-weights warning
            engine = port_eval._engine(args, torch.device("cuda"))
        require(not hasattr(engine, "module") and not hasattr(engine, "encoder_config"),
                f"baselines: {name} is not a protocol-mode wrapper")
        acc = {k: [] for k in ("psnr", "ssim", "lpips")}
        ms = []
        with port_eval.float32_math(), torch.inference_mode():
            for i in range(0, BASELINE_IMAGES, BASELINE_BATCH):
                img = images[i:i + BASELINE_BATCH]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                z, info = engine.encode(img, return_reg_log=True)
                rec = engine.decode(z).float()
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                require(info == {} and tuple(rec.shape) == tuple(img.shape),
                        f"baselines: {name} gave {tuple(rec.shape)}, {info}")
                out = port_eval.metrics_of(img, rec, inception, lpips)
                for k in acc:
                    acc[k].append(out[k].float().cpu().numpy())
        vals = {k: np.concatenate(v) for k, v in acc.items()}
        require(all(np.isfinite(v).all() for v in vals.values()),
                f"baselines: {name} metrics not finite")
        rows[name] = {"latent": list(z.shape), **{k: float(v.mean()) for k, v in vals.items()},
                      "batch_ms": ms,
                      "img_per_s_past_first_batch": BASELINE_BATCH * (len(ms) - 1)
                      / (sum(ms[1:]) / 1e3),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        del engine, z, rec
        torch.cuda.empty_cache()
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "baselines",
            "entry_point": "vqvae_from_gaussian_vae_tpu_torch.eval (protocol mode: _engine, "
                           "metrics_of)",
            "dtype": "float32", "batch": BASELINE_BATCH, "images": BASELINE_IMAGES,
            "resolution": RES, "weights": "seeded (no checkpoints); Inception, LPIPS seeded",
            "models": rows}


# the WAN video VAE at the published Wan2.1 / Qwen-Image widths, float32
WAN_FRAMES = 1 + 4 * 2  # T = 1 + 4k: the first frame alone, then two 4-frame chunks
WAN_FIRST_CHUNK_ATOL = 1e-4


def run_wan_clip(gen) -> dict:
    """``AutoencoderKLWan`` (base 96, z 16, dim_mult (1, 2, 4, 4), two
    temporal stages; seeded weights) in float32 with TF32 off:
    ``encode_chunked`` -> ``decode_chunked`` of one seeded 9-frame 256x256
    clip, the diffusers streaming path (cuDNN's Conv3d / Conv2d, the
    per-frame attention in float32 matmuls: no hand-written kernel, as the
    JAX package has no ``pallas_call`` there).  The latent is (1, 3, 32, 32,
    16) and the clip (1, 9, 256, 256, 3), finite and within [-1, 1]; the
    first chunk is the whole-clip ``encode`` / ``decode`` of frame 0 alone,
    within 1e-4; the ms of two passes of each direction and frames/s of the
    second (past cuDNN's first calls), peak memory."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.models.wan import AutoencoderKLWan

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AutoencoderKLWan(seed=SEED, device="cuda")
    build_s = time.perf_counter() - t0
    clip = torch.rand((1, WAN_FRAMES, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    runs = []
    for _ in range(2):
        box = {}
        enc_ms = _host_ms(lambda: box.update(post=model.encode_chunked(clip)))
        dec_ms = _host_ms(lambda: box.update(rec=model.decode_chunked(box["post"].mean)))
        runs.append((box["post"], box["rec"], enc_ms, dec_ms))
    post, rec, enc_ms, dec_ms = runs[-1]
    f = RES // 8
    require(tuple(post.mean.shape) == (1, 3, f, f, 16),
            f"wan_clip: latent {tuple(post.mean.shape)}")
    require(tuple(rec.shape) == (1, WAN_FRAMES, RES, RES, 3), f"wan_clip: clip {tuple(rec.shape)}")
    require(bool(torch.isfinite(rec).all()) and float(rec.abs().max()) <= 1.0,
            "wan_clip: the decoded clip is not finite or leaves [-1, 1]")
    repeat = {"moments": float((runs[0][0].parameters - post.parameters).abs().max()),
              "clip": float((runs[0][1] - rec).abs().max())}
    whole_enc = model.encode(clip[:, :1])
    enc_err = float((post.parameters[:, :1] - whole_enc.parameters).abs().max())
    whole_dec = model.decode(post.mean[:, :1])
    dec_err = float((rec[:, :1] - whole_dec).abs().max())
    require(enc_err <= WAN_FIRST_CHUNK_ATOL and dec_err <= WAN_FIRST_CHUNK_ATOL,
            f"wan_clip: first chunk against the whole-clip path: encode {enc_err}, "
            f"decode {dec_err} > {WAN_FIRST_CHUNK_ATOL}")
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated() / 2**30
    pass_ms = {"encode_ms": [r[2] for r in runs], "decode_ms": [r[3] for r in runs]}
    del model, runs, post, rec, whole_enc, whole_dec
    torch.cuda.empty_cache()
    return {"phase": "wan_clip", "model": "AutoencoderKLWan (Wan2.1 / Qwen-Image widths: "
            "base 96, z 16, dim_mult 1 2 4 4, temperal_downsample F T T), float32, TF32 off",
            "parameters": n_params, "build_s": build_s, "frames": WAN_FRAMES,
            "resolution": RES, "latent": [1, 3, f, f, 16],
            "first_chunk_vs_whole_clip_max_abs": {"encode_moments": enc_err,
                                                  "decode": dec_err},
            "tolerance": f"atol {WAN_FIRST_CHUNK_ATOL}",
            "second_pass_vs_first_max_abs": repeat,
            **pass_ms,
            "encode_frames_per_s": WAN_FRAMES / (enc_ms / 1e3),
            "decode_frames_per_s": WAN_FRAMES / (dec_ms / 1e3),
            "peak_mem_gib": peak}


# the video sweep: sd3unet_gq_0.25 in bf16 tokenizes clips as frame batches
VIDEO_CLIPS = 4
VIDEO_FRAMES = 9  # the least that I3D takes
VIDEO_BATCH = 2  # clips a batch: 18 frames for the tokenizer
VGG_LPIPS_REL = 1e-4


def write_clips(folder: str, n: int, frames: int, seed: int = SEED) -> str:
    """n seeded GIF clips of ``frames`` RES x RES frames: a gradient that
    drifts from frame to frame, plus noise."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:RES, 0:RES]
    for c in range(n):
        imgs = []
        for t in range(frames):
            base = np.stack([(xx * (c + 1) + 5 * t) % 256, (yy * 3 + 7 * c + 9 * t) % 256,
                             (xx + yy + 3 * t) % 256], -1)
            arr = np.clip(base + rng.integers(-20, 20, base.shape), 0, 255).astype(np.uint8)
            imgs.append(Image.fromarray(arr))
        imgs[0].save(os.path.join(folder, f"clip_{c:02d}.gif"), save_all=True,
                     append_images=imgs[1:], duration=40, loop=0)
    return folder


def _seeded_i3d_weights(path: str, seed: int = SEED) -> str:
    """A seeded I3D ``state_dict``: convs at He scale, BatchNorm affine and
    statistics away from identity (so that the logits keep their size)."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.evaluations import i3d

    net = i3d.InceptionI3d()
    i3d.seed_weights(net, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if t.dim() == 5:
                t.mul_(2 ** 0.5)
            elif name.endswith("running_mean") or name.endswith("bn.bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith("running_var") or name.endswith("bn.weight"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    torch.save(net.state_dict(), path)
    return path


def _check_vgg_lpips(gen) -> dict:
    """C6 on the card: ``get_lpips(..., network_type="vgg")`` on CUDA tensors
    against the same seeded metric on the CPU."""
    import torch
    from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
    from vqvae_from_gaussian_vae_tpu_torch.evaluations import lpips_metric

    x = torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    y = (x + 0.1 * torch.rand(x.shape, generator=gen, device="cuda")).clamp(0, 1)
    with port_eval.float32_math():
        got = lpips_metric.get_lpips(x, y, network_type="vgg").cpu()
        want = lpips_metric.get_lpips(x.cpu(), y.cpu(), network_type="vgg")
    err = float((got - want).abs().max())
    bar = VGG_LPIPS_REL * max(1.0, float(want.abs().max()))
    require(err <= bar, f"video_eval: VGG LPIPS card vs CPU {err} > {bar}")
    lpips_metric._METRICS.clear()
    return {"card": got.tolist(), "cpu": want.tolist(), "max_abs": err,
            "tolerance": f"{VGG_LPIPS_REL} x max(1, |cpu|)"}


def run_video_eval(gen) -> dict:
    """The port's evaluation entry point in video mode, ``main(argv)`` with
    ``--video --fvd --num_frames 9 --bs 2 --dtype bfloat16`` on
    sd3unet_gq_0.25 (full width and depth, seeded weights) over 4 seeded
    256x256 GIF clips, with seeded Inception, LPIPS and I3D weight files:
    each batch of 2 clips tokenized as 18 frames with exactly the inference
    step's launches (GQ 1, downsample 3, upsample 3, flash 5), finite
    PSNR, SSIM, LPIPS, FID and FVD; frames/s of the tokenizer and I3D's ms
    a clip; then the VGG LPIPS on the card against the CPU (C6)."""
    import contextlib
    import shutil
    import tempfile

    import numpy as np
    import torch
    from vqvae_from_gaussian_vae_tpu_torch import eval as port_eval
    from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import AutoencodingEngine

    tmp = tempfile.mkdtemp(prefix="gvq_video_")
    try:
        clips = write_clips(os.path.join(tmp, "clips"), VIDEO_CLIPS, VIDEO_FRAMES)
        inc, lp = _seeded_metric_weights(tmp)
        i3d_path = _seeded_i3d_weights(os.path.join(tmp, "i3d.pth"))
        argv = ["--base", os.path.join(ROOT, EVAL_CONFIG), "--dataset", clips, "--img_size",
                str(RES), "--bs", str(VIDEO_BATCH), "--dtype", "bfloat16", "--video", "--fvd",
                "--num_frames", str(VIDEO_FRAMES), "--inception_weights", inc,
                "--lpips_weights", lp, "--i3d_weights", i3d_path]
        counters = launch_counters()
        spans, frames, i3d_ms = [], [], []
        encode, decode, make_i3d = (AutoencodingEngine.encode, AutoencodingEngine.decode,
                                    port_eval._i3d)

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def encode_timed(engine, x, *args, **kwargs):
            frames.append(int(x.shape[0]))
            spans.append([event()])
            return encode(engine, x, *args, **kwargs)

        def decode_timed(engine, z, *args, **kwargs):
            out = decode(engine, z, *args, **kwargs)
            spans[-1].append(event())
            return out

        def i3d_timed(*args, **kwargs):
            fn = make_i3d(*args, **kwargs)

            def timed(videos):  # the wall ms a clip of one batch's I3D call
                box = []
                i3d_ms.append(_host_ms(lambda: box.append(fn(videos))) / len(videos))
                return box[0]
            return timed

        for k in counters.values():  # the path's counts: 0 just before it
            k.launches = 0
        t0 = time.perf_counter()
        with _Patched((AutoencodingEngine, "encode", encode_timed),
                      (AutoencodingEngine, "decode", decode_timed),
                      (port_eval, "_i3d", i3d_timed)), contextlib.redirect_stdout(sys.stderr):
            result = port_eval.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in counters.items() if k.launches}
        batches = len(frames)
        require(batches == VIDEO_CLIPS // VIDEO_BATCH
                and frames == [VIDEO_BATCH * VIDEO_FRAMES] * batches,
                f"video_eval: frame batches {frames}")
        per_batch = {k: v / batches for k, v in launches.items()}
        require(per_batch == EVAL_LAUNCHES, f"video_eval: launches a frame batch {per_batch}")
        summary = {k: float(np.nanmean(result[k])) for k in ("psnr", "ssim", "lpips")}
        summary.update(fid=float(result["fid"]), fvd=float(result["fvd"]))
        require(all(math.isfinite(v) for v in summary.values()),
                f"video_eval: a metric is not finite: {summary}")
        require(result["count"] == VIDEO_CLIPS * VIDEO_FRAMES,
                f"video_eval: {result['count']} frames")
        tok_ms = [b.elapsed_time(e) for b, e in spans]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    vgg = _check_vgg_lpips(gen)
    torch.cuda.empty_cache()
    return {"phase": "video_eval", "entry_point": "vqvae_from_gaussian_vae_tpu_torch.eval:main "
            "--video --fvd", "config": EVAL_CONFIG, "dtype": "bfloat16",
            "clips": VIDEO_CLIPS, "frames_a_clip": VIDEO_FRAMES, "clips_a_batch": VIDEO_BATCH,
            "resolution": RES, "weights": "seeded engine; seeded Inception, LPIPS (alex), I3D "
            "(He-scaled convs, BatchNorm away from identity)",
            "launches_per_frame_batch": per_batch, "metrics": summary,
            "tokenizer_ms_a_batch": tok_ms,
            "tokenizer_frames_per_s_past_first_batch": (
                VIDEO_BATCH * VIDEO_FRAMES * (batches - 1) / (sum(tok_ms[1:]) / 1e3)
                if batches > 1 else None),
            "i3d_ms_a_clip": i3d_ms, "main_seconds": main_s,
            "frames_per_s_whole_sweep": VIDEO_CLIPS * VIDEO_FRAMES / main_s,
            "vgg_lpips_card_vs_cpu": vgg}


PROFILE_STEPS = 2
PROFILE_IMAGES = 2 * BATCH
PROFILE_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                   "flash_bwd_dq_sm90_kernel")


def run_profile_entry(gen) -> dict:
    """The training entry point's ``--profile`` (``utils/profiling.py:trace``)
    on bsqvit_gq_0.25 with the bf16 overlay at 2 layers for 2 steps through
    ``main(argv)``: ``<logdir>/trace/trace.json`` exists and holds CUDA
    kernel events, the packed flash forward's and backward's among them."""
    import contextlib
    import shutil
    import tempfile

    import torch
    from vqvae_from_gaussian_vae_tpu_torch import main as port_main

    del gen  # the images come from SEED
    tmp = tempfile.mkdtemp(prefix="gvq_profile_")
    try:
        images = write_images(os.path.join(tmp, "images"), PROFILE_IMAGES)
        argv = ["--base", os.path.join(ROOT, TRAIN_PATHS["bsqvit"]["configs"][0]),
                os.path.join(ROOT, BF16_OVERLAY), "--name", "profile", "--profile",
                "--max_steps", str(PROFILE_STEPS), "--seed", str(SEED), "--no-test",
                "--logdir", os.path.join(tmp, "logs"),
                f"data.params.train.params.root={images}",
                f"model.params.encoder_config.params.layers={TRAINER_VIT_LAYERS}",
                f"model.params.loss_config.params.disc_start={TRAINER_DISC_START}"]
        counters = launch_counters()
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            trainer = port_main.main(argv)
        wall_s = time.perf_counter() - t0
        path = os.path.join(trainer.logdir, "trace", "trace.json")
        require(os.path.exists(path), f"profile: no trace at {path}")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        named = {k: sum(k in e.get("name", "") for e in kernels) for k in PROFILE_KERNELS}
        require(kernels and all(named.values()),
                f"profile: {len(kernels)} CUDA kernel events; the flash kernels {named}")
        launches = {n: k.launches for n, k in counters.items() if k.launches}
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "profile", "entry_point": "vqvae_from_gaussian_vae_tpu_torch.main:main "
            "--profile", "config": TRAIN_PATHS["bsqvit"]["configs"][0], "overlay": BF16_OVERLAY,
            "layers": TRAINER_VIT_LAYERS, "steps": PROFILE_STEPS, "trace_bytes": size,
            "events": len(events), "kernel_events": len(kernels),
            "flash_kernel_events": named, "launches": launches, "wall_s": wall_s}


UNET_LINEAR = {"attn_type": "linear"}
UNET_LINEAR_LAUNCHES = {"gq_argmax": 1, "downsample_conv3x3_gn": 3,
                        "upsample_nearest_conv3x3_gn": 3}


def run_gate_linear_attention(gen) -> dict:
    """sd3unet_gq_0.25 with ``attn_type: linear`` at full width, bs = 16,
    bf16: one encode -> dequant step launches the resample kernels and the
    search and no flash kernel (the linear blocks are plain torch, as in the
    JAX model); held to a float32 engine at bs = 2."""
    import torch

    engine, _ = build_engine(SERVE_CONFIG, "bfloat16", UNET_LINEAR)
    require(type(engine.encoder.down[3].attn[0]).__name__ == "LinAttnBlock",
            "linear gate: the 32x32 level has no LinAttnBlock")
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1

    def step():
        zhat, reg = engine.encode(x, return_reg_log=True)
        return zhat, reg["indices"], engine.dequant(reg["indices"])

    (zhat, idx, xhat), counts = counted(launch_counters(), step)
    launches = require_launches("sd3unet, linear attention", counts, UNET_LINEAR_LAUNCHES)
    require(tuple(idx.shape) == PATHS["sd3unet"]["indices"]
            and bool(torch.isfinite(xhat.float()).all()),
            f"linear gate: indices {tuple(idx.shape)}, xhat finite")
    ms = _host_ms(step)
    ref, _ = build_engine(SERVE_CONFIG, "float32", UNET_LINEAR)
    enc_rel = rel_l2(engine.encode(x[:2], unregularized=True)[0],
                     ref.encode(x[:2], unregularized=True)[0])
    dec_rel = rel_l2(engine.decode(zhat[:2]), ref.decode(zhat[:2]))
    require(enc_rel <= 0.1 and dec_rel <= 0.1,
            f"linear gate, bf16 vs float32: encoder rel L2 {enc_rel}, decoder {dec_rel}")
    del ref, engine
    torch.cuda.empty_cache()
    return {"phase": "gate", "check": "sd3unet_linear_attention", "overrides": UNET_LINEAR,
            "batch": BATCH, "launches_per_step": launches, "step_ms": ms,
            "bf16_vs_fp32_rel_l2": {"encoder": enc_rel, "decoder": dec_rel}}


def profile_step(step):
    """Device time over one encode -> dequant step: by kernel, and by the
    PyTorch op that launched it (the hand-written kernels, launched through
    ctypes, appear only among the kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, ops = [], []
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows = kernels if ev.device_type == DeviceType.CUDA else ops
            rows.append((dev_us, ev.key, ev.count))
    busy_ms = sum(r[0] for r in kernels) / 1e3

    def top(rows, n):
        rows.sort(reverse=True)
        return [{"name": k[:100], "ms": us / 1e3, "count": c} for us, k, c in rows[:n]]

    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "ops_device_ms": sum(r[0] for r in ops) / 1e3,
            "top_ops": top(ops, 20), "top_kernels": top(kernels, 20)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of one main-path step")
    ap.add_argument("--ddp-worker", nargs=2, metavar=("OUT_DIR", "EVAL_DIR"),
                    help="(a rank of the ddp and eval_sweep phases, under torchrun) the "
                         "training entry point on the arguments after --, then the evaluation "
                         "entry point on the arguments in EVAL_DIR/argv.json")
    ap.add_argument("entry_argv", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    preset = [k for k in KERNEL_ENV if k in os.environ]
    if preset:
        print(f"chip_smoke: unset {preset} first: the smoke drives each path with the "
              "kernel switches it sets itself", file=sys.stderr)
        return 4
    sys.path.insert(0, ROOT)
    try:
        from vqvae_from_gaussian_vae_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here ({e})", file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ddp_worker:
        out_dir, eval_dir = args.ddp_worker
        ddp_worker(out_dir, args.entry_argv)
        torch.cuda.empty_cache()
        with open(os.path.join(eval_dir, "argv.json")) as f:
            return eval_worker(eval_dir, json.load(f))
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = t_start = time.perf_counter()
    _build.library()
    log_path = os.path.join(_build.build_dir(), "nvcc.log")
    ptxas = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": _build.build_dir(),
          "ptxas": ptxas, "flash_f32_split_tf32": f32_build_facts()})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # FLUX's and the baselines' draws come from a generator of their own, so
    # that every other phase draws what it drew before they were added
    flux_gen = torch.Generator(device="cuda").manual_seed(SEED)
    seconds = {}
    t_phase = time.perf_counter()
    # first, so that the daemon's worker thread makes the first launches
    emit(run_serve(gen))
    torch.cuda.empty_cache()
    seconds["serve"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    kernels = []
    for check in (check_gq, lambda g: check_resample(g, "down"),
                  lambda g: check_resample(g, "up"), check_flash, check_flash_qkv,
                  lambda g: check_layer_norm(g, False), lambda g: check_layer_norm(g, True),
                  check_flash_qkv_res, check_flash_qkv_bwd,
                  lambda g: check_layer_norm_bwd(g, False),
                  lambda g: check_layer_norm_bwd(g, True),
                  lambda g: check_resample_bwd(g, "down"), lambda g: check_resample_bwd(g, "up"),
                  check_flash_res, check_flash_bwd, check_fused_gn_conv, check_conv3x3_wgrad,
                  check_gn_swish_bwd, check_flash_lean, check_flash_lean_f32,
                  check_flash_hdit, lambda g: check_flash_flux(flux_gen)):
        out = check(gen)
        for k in (out if isinstance(out, list) else [out]):
            emit({"phase": "kernel", **k})
            kernels.append(k)
        torch.cuda.empty_cache()

    seconds["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    launches = {}
    for path in PATHS:
        e2e = run_e2e(gen, args.profile, path)
        emit(e2e)
        launches[path] = e2e["launches_per_step"]
        torch.cuda.empty_cache()
    seconds["e2e"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    train_results = {}
    for path in TRAIN_PATHS:
        train = run_train(gen, args.profile, path)
        emit(train)
        launches[f"{path}_train_ae"] = train["launches_per_ae_step"]
        train_results[path] = train
        torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    for path in REG_PATHS:
        emit(run_regularizer(gen, path))
        torch.cuda.empty_cache()
    seconds["regularizers"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    emit(run_trainer(gen, train_results))
    torch.cuda.empty_cache()
    seconds["trainer"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    run_data_parallel(train_results)
    torch.cuda.empty_cache()
    seconds["ddp_and_eval_sweep"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    for dtype in ("bfloat16", "float32"):
        op = run_flash_head_major(gen, dtype)
        emit(op)
        launches[op["path"]] = op["launches_per_call"]
        torch.cuda.empty_cache()
    seconds["head_major"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    lab_lines, lab_summary = run_flash_labs(gen)
    for line in lab_lines:
        emit(line)
    ln_lines, ln_summary = run_ln_matmul_lab(gen)
    for line in ln_lines:
        emit(line)
    seconds["labs"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    post = run_post(gen)
    emit(post)
    launches["post"] = post["launches_per_post"]
    launches["post_train_step"] = post["launches_per_train_step"]
    seconds["post"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    flux = run_flux(flux_gen)
    emit(flux)
    launches["flux"] = flux["launches_per_forward"]
    seconds["flux"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    dequant = run_flux_dequant(flux_gen)
    emit(dequant)
    launches["flux_dequant"] = dequant["launches_per_dequant"]
    seconds["flux_dequant"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    emit(run_baselines(flux_gen))
    seconds["baselines"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    emit(run_wan_clip(flux_gen))
    torch.cuda.empty_cache()
    seconds["wan_clip"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    emit(run_video_eval(flux_gen))
    seconds["video_eval"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    emit(run_profile_entry(flux_gen))
    seconds["profile"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    for gate in (run_gate_unet_odd, run_gate_vit_disabled, run_gate_conv_bwd,
                 run_gate_linear_attention):
        emit(gate(gen))
    seconds["gates"] = time.perf_counter() - t_phase
    emit({"phase": "seconds", **seconds, "total": time.perf_counter() - t_start})

    summary = []
    for k in kernels:
        shapes = [s for s in k["shapes"] if s.get("main_path", True)]
        # one main-path step's launches at each shape: given per shape, or the
        # step's launches spread evenly (the flash kernel runs 5 times at its one shape)
        counts = [s.get("per_step", k["per_step"] // len(shapes)) for s in shapes]

        def total(key, shapes=shapes, counts=counts):
            vals = [s[key] for s in shapes]
            return None if any(v is None for v in vals) else sum(
                n * v for n, v in zip(counts, vals))

        summary.append({"name": k["name"], "route": k["route"], "source": k["source"],
                        "replaces": k["replaces"],
                        "launches": sum(launches[k["path"]][n]
                                        for n in k.get("counters", [k["name"]])),
                        "path": k["path"],
                        "max_abs_err": max(s["max_abs_err"] for s in shapes),
                        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
                        "bound_ms": total("bound_ms"),
                        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
                        "library_ms": total("library_ms"),
                        "per": "one main-path step (sum over its launches)"})
    names = [k["name"] for k in summary + lab_summary + ln_summary]
    require(len(set(names)) == len(names), f"the kernels line repeats a name: {names}")
    emit({"kernels": summary + lab_summary + ln_summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
