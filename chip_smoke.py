#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``vqvae_from_gaussian_vae_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py             # what a check of the port runs
    python3 chip_smoke.py --profile   # adds a torch.profiler breakdown of one step

It builds the hand-written CUDA kernels from ``csrc/``, holds each one
against its plain PyTorch version at the shapes the sd3unet_gq_0.25 main
path gives it, then drives that path (encode -> 2^16 GQ search -> dequant)
through the engine a user would build from ``configs/sd3unet_gq_0.25.yaml``
at bs=16, 256x256, bf16, with seeded random weights, and checks what comes
out.  Every phase prints one JSON line.  The line before the last is the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result line.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet); a card set to a lower power limit runs below them.
PEAK_BF16 = 989e12      # tensor cores, FLOP/s
PEAK_FP32 = 67e12       # CUDA cores, FLOP/s
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    """(least time in ms, which of the two bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phases: each kernel against its plain version at main-path shapes


def near_tie_gap(got, want, mu, std, codebook) -> float:
    """Largest float64 score gap over rows where `got` != `want`; raises if
    any such row is not a near-tie."""
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import gq_scores_reference

    rows = (got != want).nonzero().flatten().tolist()
    worst = 0.0
    for r in rows:
        g, w = int(got[r]), int(want[r])
        s = gq_scores_reference(mu[r:r + 1].cpu().numpy(), std[r:r + 1].cpu().numpy(),
                                codebook[[g, w]].cpu().numpy())[0]
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
             "library_ms": None, "bound_ms": bnd, "bound_by": by,
             "flops": flops, "bytes": nbytes, "mismatches": mismatches,
             "max_abs_err": gap}
    return {"name": "gq_argmax", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/gq_argmax.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/gq_pallas.py:83",
            "tolerance": f"indices equal, or a float64 near-tie (relative {NEAR_TIE})",
            "per_step": 1, "shapes": [shape]}


def _bf16_err(got, want):
    d = (got.float() - want.float()).abs()
    ratio = float((d / (BF16_ATOL + BF16_RTOL * want.float().abs())).max())
    return float(d.max()), ratio


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
        y_p, _ = plain(x, wt, bias, a)
        torch.cuda.synchronize()
        err, ratio = _bf16_err(y_k, y_p)
        require(ratio <= 1.0, f"{kind} {shape}: kernel vs plain error {err} beyond "
                              f"atol {BF16_ATOL} + rtol {BF16_RTOL}")
        s_err = _stats_err(y_k, s_k)
        require(s_err <= STATS_RTOL, f"{kind} {shape}: stats error {s_err}")
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
        shapes.append({
            "shape": f"x {tuple(shape)} bf16" + (" + add" if add else ""),
            "kernel_ms": time_ms(lambda: kernel(x, wt, bias, a)),
            "plain_ms": time_ms(lambda: plain(x, wt, bias, a), iters=3, warmup=1),
            "library_ms": lib, "bound_ms": bnd, "bound_by": by, "flops": flops,
            "bytes": nbytes, "max_abs_err": err, "err_over_tol": ratio,
            "stats_rel_err": s_err})
        del x, a, y_k, y_p, s_k
        torch.cuda.empty_cache()
    if kind == "down":
        return {"name": "downsample_conv3x3_gn", "route": "cuda",
                "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/downsample_conv.cu",
                "replaces": "vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py:125",
                "tolerance": f"bf16 atol {BF16_ATOL} + rtol {BF16_RTOL}; stats rtol {STATS_RTOL}",
                "per_step": 3, "shapes": shapes}
    return {"name": "upsample_nearest_conv3x3_gn", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/upsample_conv.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py:199",
            "tolerance": f"bf16 atol {BF16_ATOL} + rtol {BF16_RTOL}; stats rtol {STATS_RTOL}",
            "per_step": 3, "shapes": shapes}


def check_flash(gen):
    import torch
    import torch.nn.functional as F
    from vqvae_from_gaussian_vae_tpu_torch.ops import flash_attention as fa

    b, l, heads, d = BATCH, 32 * 32, 1, 512  # the UNet AttnBlock at the 32x32 level
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
    shape = {"shape": f"q,k,v ({b},{l},{heads}x{d}) bf16",
             "kernel_ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, scale, heads)),
             "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, scale, heads)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)),
             "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
             "max_abs_err": err}
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "vqvae_from_gaussian_vae_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "vqvae_from_gaussian_vae_tpu/ops/flash_blc.py:319",
            "tolerance": f"bf16 atol {FLASH_ATOL}", "per_step": 5, "shapes": [shape]}


# ---------------------------------------------------------------------------
# the main path


def launch_counters():
    from vqvae_from_gaussian_vae_tpu_torch.ops import downsample_conv, flash_attention, gq_cuda
    from vqvae_from_gaussian_vae_tpu_torch.ops import upsample_conv

    return {"gq_argmax": gq_cuda.gq_argmax_cuda,
            "downsample_conv3x3_gn": downsample_conv.downsample_conv3x3_gn_cuda,
            "upsample_nearest_conv3x3_gn": upsample_conv.upsample_nearest_conv3x3_gn_cuda,
            "flash_attention_fwd": flash_attention.flash_attention_cuda}


def build_engine(dtype: str):
    from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config

    cfg = load_config(os.path.join(ROOT, "configs", "sd3unet_gq_0.25.yaml"))
    params = cfg["model"]["params"]
    params["loss_config"] = None
    for key in ("encoder_config", "decoder_config"):
        params[key]["params"]["dtype"] = dtype
    return instantiate_from_config(cfg["model"], seed=SEED, device="cuda"), cfg


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def run_e2e(gen, profile: bool):
    import torch
    from vqvae_from_gaussian_vae_tpu_torch.ops.gq_search import argmax_blocked, score_operands
    from vqvae_from_gaussian_vae_tpu_torch.quantization.gaussian import _split_posterior
    from vqvae_from_gaussian_vae_tpu_torch.utils import flops as F

    engine, cfg = build_engine("bfloat16")
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda") * 2 - 1
    counters = launch_counters()

    # the main path, counted: encode -> GQ search -> dequant
    for fn in counters.values():
        fn.launches = 0
    z, reg = engine.encode(x, return_reg_log=True)
    xhat = engine.dequant(reg["indices"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = {"gq_argmax": 1, "downsample_conv3x3_gn": 3,
                "upsample_nearest_conv3x3_gn": 3, "flash_attention_fwd": 5}
    require(launches == expected, f"launches per step {launches} != {expected}")

    idx = reg["indices"]
    require(tuple(z.shape) == (BATCH, 32, 32, 16), f"z shape {tuple(z.shape)}")
    require(tuple(idx.shape) == (BATCH, 32, 32, 1) and idx.dtype == torch.int32,
            f"indices {tuple(idx.shape)} {idx.dtype}")
    require(int(idx.min()) >= 0 and int(idx.max()) < 65536, "index out of range")
    require(tuple(xhat.shape) == (BATCH, RES, RES, 3), f"xhat shape {tuple(xhat.shape)}")
    require(bool(torch.isfinite(xhat.float()).all()), "dequant output not finite")
    require(bool(torch.isfinite(z).all()), "zhat not finite")

    # dequant(indices) must be decode(zhat): the same latents through the same decoder
    xrec = engine.decode(z)
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
    ref_engine, _ = build_engine("float32")
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
    step_flops = BATCH * (F.unet_encoder_flops(enc_cfg) + F.unet_decoder_flops(enc_cfg)
                          + F.gq_search_flops(32 * 32, 16, 65536))
    result = {"phase": "e2e", "config": "configs/sd3unet_gq_0.25.yaml", "dtype": "bfloat16",
              "batch": BATCH, "resolution": RES, "launches_per_step": launches,
              "z": list(z.shape), "indices": list(idx.shape), "xhat": list(xhat.shape),
              "dequant_vs_decode_max_abs": deq_err,
              "gq_vs_plain_mismatches": mismatches, "gq_max_near_tie_gap": gap,
              "bf16_vs_fp32_rel_l2": {"encoder": enc_rel, "decoder": dec_rel},
              "step_ms": 1e3 * dt / iters, "img_per_s": BATCH * iters / dt,
              "step_flops": step_flops,
              "achieved_tflops": step_flops * iters / dt / 1e12,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if profile:
        result["profile"] = profile_step(step)
    return result


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
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from vqvae_from_gaussian_vae_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here ({e})", file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    log_path = os.path.join(_build.build_dir(), "nvcc.log")
    ptxas = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": _build.build_dir(),
          "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = []
    for check in (check_gq, lambda g: check_resample(g, "down"),
                  lambda g: check_resample(g, "up"), check_flash):
        k = check(gen)
        emit({"phase": "kernel", **k})
        kernels.append(k)

    e2e = run_e2e(gen, args.profile)
    emit(e2e)

    summary = []
    for k in kernels:
        shapes = k["shapes"]
        # one main-path step's launches: the flash kernel runs 5 times at its one shape
        reps = k["per_step"] // len(shapes)

        def total(key, shapes=shapes, reps=reps):
            vals = [s[key] for s in shapes]
            return None if any(v is None for v in vals) else reps * sum(vals)

        summary.append({"name": k["name"], "route": k["route"], "source": k["source"],
                        "replaces": k["replaces"],
                        "launches": e2e["launches_per_step"][k["name"]],
                        "max_abs_err": max(s["max_abs_err"] for s in shapes),
                        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
                        "bound_ms": total("bound_ms"),
                        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
                        "library_ms": total("library_ms"),
                        "per": "one main-path step (sum over its launches)"})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
