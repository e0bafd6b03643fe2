"""The spread over seeds of one ae step's bf16 gradient against float32's,
with the kernels on and off.

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.grad_spread [--path sd3unet] [--seeds 8]

On a CUDA card, from the repository root (it reuses ``chip_smoke.py``'s
engine builder).  The bf16 engine of a training path of ``chip_smoke.py``
(the bf16 overlay, full width and depth, seeded weights) and a float32
engine with the same weights are built once; the trainer's state is taken
past ``disc_start`` and moved by as many ae + disc pairs at bs 16 as the
smoke's train phase runs before its check (one counted, ``TRAIN_WARMUP``
and ``TRAIN_TIMED``), on one seeded batch as there.  For each seed s, a batch
(bs 2) and eps are drawn from a CUDA generator seeded s, in
``chip_smoke.train_grad_check``'s order, and the bf16 ae gradient is held
to the float32 one under four settings: the default (every kernel),
``GVQ_DISABLE_FUSED_KERNELS=1`` (the plain path), ``GVQ_DOWNSAMPLE_BWD=conv``
and ``GVQ_UPSAMPLE_BWD=conv`` (one resample backward on cuDNN).  TF32 is
off.  It prints one JSON line a setting (the relative L2 of the whole
gradient for each seed, with its minimum, median and maximum, and each
seed's worst tensor), then the card's ``nvidia-smi`` name and power limit.
The smoke's bar (``TRAIN_GRAD_REL_L2``) is printed beside, not applied.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SETTINGS = {"kernels": {}, "plain": {"GVQ_DISABLE_FUSED_KERNELS": "1"},
            "downsample_bwd_conv": {"GVQ_DOWNSAMPLE_BWD": "conv"},
            "upsample_bwd_conv": {"GVQ_UPSAMPLE_BWD": "conv"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="sd3unet")
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("grad_spread: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from vqvae_from_gaussian_vae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    engine, builder, _ = smoke.build_trainer(args.path, "bfloat16")
    ref_engine, ref_builder, _ = smoke.build_trainer(args.path, "float32")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    batch = {"img": torch.rand((smoke.BATCH, smoke.RES, smoke.RES, 3), generator=gen,
                               device="cuda") * 2 - 1}
    state = builder.init_state(smoke.SEED, batch)
    state.step = engine.loss.disc_start + 10  # both phases run their real graphs
    for _ in range(1 + smoke.TRAIN_WARMUP + smoke.TRAIN_TIMED):
        builder.ae_step(state, batch, True)
        builder.disc_step(state, batch)
    ref_engine.load_state_dict(engine.state_dict())
    ref_engine.loss.load_state_dict(engine.loss.state_dict())
    tokens = smoke._train_spec(args.path)["tokens"]

    rows = {name: [] for name in SETTINGS}
    for seed in range(args.seeds):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.rand((2, smoke.RES, smoke.RES, 3), generator=g, device="cuda") * 2 - 1
        eps = torch.randn((2, tokens, engine.encoder.z_channels), generator=g, device="cuda")
        g32, _, _ = ref_builder.ae_grads(state, {"img": x}, True, eps=eps)
        whole = float(torch.cat([t.flatten() for t in g32.values()]).double().norm())
        keys = [k for k in g32 if float(g32[k].double().norm()) >= smoke.ZERO_GRAD_REL * whole]
        for name, env in SETTINGS.items():
            g16, _, _ = smoke.with_env(
                env, lambda: builder.ae_grads(state, {"img": x}, True, eps=eps))
            per = {k: smoke.rel_l2(g16[k], g32[k]) for k in keys}
            worst = max(per, key=per.get)
            total = smoke.rel_l2(torch.cat([g16[k].flatten() for k in g32]),
                                 torch.cat([g32[k].flatten() for k in g32]))
            rows[name].append({"seed": seed, "rel_l2_all": total, "worst_tensor": worst,
                               "worst_rel_l2": per[worst]})
            del g16
        del g32
        torch.cuda.empty_cache()
    for name, env in SETTINGS.items():
        vals = [r["rel_l2_all"] for r in rows[name]]
        print(json.dumps({"lab": "grad_spread", "path": args.path, "setting": name, "env": env,
                          "seeds": args.seeds, "batch": 2, "step": state.step,
                          "min": min(vals),
                          "median": statistics.median(vals), "max": max(vals),
                          "bar": smoke.TRAIN_GRAD_REL_L2, "rows": rows[name]}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
