"""Where a call of the GroupNorm + swish backward and of the LayerNorm
backward kernels spends its time, phase by phase, on the card.

Builds ``csrc/gn_swish_bwd.cu`` and ``csrc/layer_norm.cu`` on their own
with ``GVQ_TRACE`` defined (``csrc/grid_sync.cuh``: thread 0 of each block
writes (mark id, ``clock64()``) at each mark), runs the ops' wrappers on
that library at the training steps' shapes, and prints one JSON line per
shape: the call's device ms (CUDA events, ``labs/_timing.py``, on the traced
build), and for the median block by total the SM cycles charged to each
phase (the cycles since the previous mark) and their shares.  The
GroupNorm kernel's phases: ``rows1`` (pass 1's rows), ``reduce1`` (the
block's sums, its partials and its arrival at the wave's barrier), ``wait``
(the barrier), ``final`` (dgamma, dbeta), ``sum`` (the sample's constants),
``rows2`` (pass 2's rows, dx); the LayerNorm kernel's: ``slab`` (waiting
for a slab), a warp's row in three (``stats``: mean and rstd, ``means``:
the row means of wdy and wdy * xhat, ``rows``: dx), ``columns`` (the column
owners), ``tail`` and ``final`` (the barrier; dgamma, dbeta).

On a machine with one CUDA card, from the repository root:

    python3 -m vqvae_from_gaussian_vae_tpu_torch.labs.trace_norm_bwd
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

MARKS = 2048  # csrc/grid_sync.cuh kTraceMarks: (id, clock) pairs a block


def build_traced() -> tuple:
    """(the traced library, ptxas's {kernel: usage})."""
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    work = tempfile.mkdtemp(prefix="gvq-trace-")
    objs, procs, log = [], [], ""
    for name in ("gn_swish_bwd.cu", "layer_norm.cu"):
        obj = os.path.join(work, name + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-DGVQ_TRACE", "-c",
             os.path.join(_build.CSRC_DIR, name), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate()
        log += out
        if p.returncode:
            raise RuntimeError(out)
    lib_path = os.path.join(work, "libgvq_trace.so")
    subprocess.run([_build.nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
                    lib_path, *objs], check=True, stdout=subprocess.PIPE)
    lib = ctypes.CDLL(lib_path)
    for name in ("gvq_gn_swish_bwd", "gvq_layer_norm_bwd", "gvq_layer_norm_add_bwd"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("gvq_trace_set_gn", "gvq_trace_set_ln"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    usage = {_build._ANON.sub(r"<\1.cu>", k): v for k, v in _build.ptxas_usage(log).items()
             if "gn_swish_bwd_kernel" in k or "ln_bwd_kernel" in k}
    return lib, usage


def traced_call(lib, setter: str, grid: int, fn):
    """fn() once to warm up, then once with marks; -> (grid, marks, 2) of
    (id, cycles), id -1 past a block's last mark."""
    import torch

    buf = torch.full((grid, MARKS, 2), -1, dtype=torch.int64, device="cuda")
    fn()
    torch.cuda.synchronize()
    assert getattr(lib, setter)(buf.data_ptr()) == 0
    fn()
    torch.cuda.synchronize()
    assert getattr(lib, setter)(None) == 0
    return buf.cpu()


GN_PHASES = ["start", "rows1", "reduce1", "wait", "final", "sum", "rows2"]
LN_PHASES = ["start", "slab", "rows", "columns", "", "tail", "final", "stats", "means"]


def phases(marks, names) -> dict:
    """Cycles since the previous mark, charged to each mark's phase."""
    out = dict.fromkeys((n for n in names if n), 0)
    ids, clocks = marks[:, 0].tolist(), marks[:, 1].tolist()
    n = ids.index(-1) if -1 in ids else len(ids)
    for k in range(1, n):
        out[names[ids[k]]] += clocks[k] - clocks[k - 1]
    out["total"] = clocks[n - 1] - clocks[0]
    return out


def summary(per_block: list) -> dict:
    per_block.sort(key=lambda d: d["total"])
    med = per_block[len(per_block) // 2]
    return {"median_block": med,
            "shares": {k: round(v / med["total"], 4) for k, v in med.items() if k != "total"},
            "total_min_max": [per_block[0]["total"], per_block[-1]["total"]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_norm_bwd: no CUDA device is available", file=sys.stderr)
        return 2
    from vqvae_from_gaussian_vae_tpu_torch.labs._timing import time_ms
    from vqvae_from_gaussian_vae_tpu_torch.labs.profile_norm_bwd import (BATCH, GN_SITES, LN_C,
                                                                       LN_ROWS)
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build
    from vqvae_from_gaussian_vae_tpu_torch.ops import gn_swish_bwd as gsb
    from vqvae_from_gaussian_vae_tpu_torch.ops import layer_norm as ln

    lib, usage = build_traced()
    _build.library = lambda: lib  # the wrappers launch the traced kernels
    print(json.dumps({"ptxas": usage}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (h, c), dtype in [*((s, torch.bfloat16) for s in GN_SITES), ((128, 256), torch.float32)]:
        x = (2 * torch.randn((BATCH, h, h, c), generator=gen, device="cuda") + 0.5).to(dtype)
        dy = torch.randn((BATCH, h, h, c), generator=gen, device="cuda").to(dtype)
        gamma = 1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.2 * torch.randn((c,), generator=gen, device="cuda")
        _, (mean_c, rstd_c) = gsb.gn_swish_ref(x, gamma, beta)
        plan = gsb.gn_bwd_plan(BATCH, h * h, c, 32, dtype)
        fn = lambda: gsb.gn_swish_bwd_cuda(x, dy, mean_c, rstd_c, gamma, beta)  # noqa: E731
        marks = traced_call(lib, "gvq_trace_set_gn", plan.grid, fn)
        print(json.dumps({"op": "gn_swish_bwd", "shape": [BATCH, h, h, c],
                          "dtype": str(dtype).split(".")[-1], "ms": time_ms(fn),
                          "plan": plan.__dict__,
                          **summary([phases(marks[j], GN_PHASES) for j in range(plan.grid)])}),
              flush=True)
        del x, dy, fn
    for dtype in (torch.bfloat16, torch.float32):
        x = (2 * torch.randn((LN_ROWS, LN_C), generator=gen, device="cuda") + 0.5).to(dtype)
        dy = torch.randn((LN_ROWS, LN_C), generator=gen, device="cuda").to(dtype)
        ds_in = torch.randn((LN_ROWS, LN_C), generator=gen, device="cuda").to(dtype)
        w = 1 + 0.3 * torch.randn((LN_C,), generator=gen, device="cuda")
        for add in (False, True):
            plan = ln.ln_bwd_plan(LN_ROWS, LN_C, dtype, add=add)
            fn = ((lambda: ln.layer_norm_add_bwd_cuda(x, w, dy, ds_in)) if add
                  else (lambda: ln.layer_norm_bwd_cuda(x, w, dy)))
            marks = traced_call(lib, "gvq_trace_set_ln", plan.grid, fn)
            print(json.dumps({"op": "layer_norm_add_bwd" if add else "layer_norm_bwd",
                              "shape": [LN_ROWS, LN_C], "dtype": str(dtype).split(".")[-1],
                              "ms": time_ms(fn), "plan": plan.__dict__,
                              **summary([phases(marks[j], LN_PHASES)
                                         for j in range(plan.grid)])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
