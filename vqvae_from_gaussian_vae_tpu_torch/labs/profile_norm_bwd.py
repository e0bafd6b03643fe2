"""Device time of each CUDA kernel that one call of the GroupNorm + swish
backward (``ops/gn_swish_bwd.py:gn_swish_bwd_cuda``) and of the LayerNorm
and LayerNorm-add backward (``ops/layer_norm.py:layer_norm_bwd_cuda``,
``layer_norm_add_bwd_cuda``) runs, at the shapes the training steps give
them: the sd3unet ae step's four GroupNorm sites at bs=16 and the bsqvit
ae step's (16384, 768) token rows.

On a machine with one CUDA card, from the repository root:

    python3 vqvae_from_gaussian_vae_tpu_torch/labs/profile_norm_bwd.py [--root CHECKOUT]

``--root`` imports the port from another checkout (its own kernels, built
there), so that two trees are profiled by one script.  One JSON line per
shape: each kernel's mean device ms a launch and launches a call
(torch.profiler over 5 calls after a warm-up call), and the call's mean
device ms by CUDA events (``labs/_timing.py``); the card's ``nvidia-smi``
name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BATCH = 16
GN_SITES = [(256, 128), (128, 256), (64, 512), (32, 512)]  # (H = W, C) of the sd3unet sites
LN_ROWS, LN_C = BATCH * 32 * 32, 768


def kernels_per_call(fn, calls: int = 5) -> dict:
    """{kernel: {"ms": mean device ms a launch, "per_call": launches a call}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:120]: {"ms": ev.self_device_time_total / 1e3 / ev.count,
                           "per_call": ev.count / calls}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout whose port to import")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("profile_norm_bwd: no CUDA device is available", file=sys.stderr)
        return 2
    from vqvae_from_gaussian_vae_tpu_torch.labs._timing import time_ms
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build
    from vqvae_from_gaussian_vae_tpu_torch.ops import gn_swish_bwd as gsb
    from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln

    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (h, c), dtype in [*((s, torch.bfloat16) for s in GN_SITES), ((128, 256), torch.float32)]:
        x = (2 * torch.randn((BATCH, h, h, c), generator=gen, device="cuda") + 0.5).to(dtype)
        dy = torch.randn((BATCH, h, h, c), generator=gen, device="cuda").to(dtype)
        gamma = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.2 * torch.randn((c,), generator=gen, device="cuda")
        _, (mean_c, rstd_c) = gsb.gn_swish_ref(x, gamma, beta)
        call = lambda: gsb.gn_swish_bwd_cuda(x, dy, mean_c, rstd_c, gamma, beta)  # noqa: E731
        print(json.dumps({"op": "gn_swish_bwd", "root": root,
                          "shape": [BATCH, h, h, c], "dtype": str(dtype).split(".")[-1],
                          "call_ms": time_ms(call), "kernels": kernels_per_call(call)}),
              flush=True)
        del x, dy, call
    for dtype in (torch.bfloat16, torch.float32):
        x = (2 * torch.randn((LN_ROWS, LN_C), generator=gen, device="cuda") + 0.5).to(dtype)
        dy = torch.randn((LN_ROWS, LN_C), generator=gen, device="cuda").to(dtype)
        ds_in = torch.randn((LN_ROWS, LN_C), generator=gen, device="cuda").to(dtype)
        w = 1 + 0.3 * torch.randn((LN_C,), generator=gen, device="cuda")
        for name, call in (("layer_norm_bwd", lambda: ln.layer_norm_bwd_cuda(x, w, dy)),
                           ("layer_norm_add_bwd",
                            lambda: ln.layer_norm_add_bwd_cuda(x, w, dy, ds_in))):
            print(json.dumps({"op": name, "root": root, "shape": [LN_ROWS, LN_C],
                              "dtype": str(dtype).split(".")[-1], "call_ms": time_ms(call),
                              "kernels": kernels_per_call(call)}), flush=True)
        del x, dy, ds_in
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
