"""Which module of an engine's encoder gives an image other bits when the
image sits at another position of its batch.

    python -m vqvae_from_gaussian_vae_tpu_torch.labs.batch_position_probe \\
        [--config configs/sd3unet_gq_0.25.yaml] [--dtype bfloat16] [--batch 16] [--res 256]

The encoder (seeded weights, on the card) runs on a batch x and on x with
every image moved one position on (``torch.roll``), then on 2 x batch
images and the same images with the even ones first; a forward hook
compares each module's output image by image.  It prints one JSON line a
permutation: the modules compared, the modules whose output differs, and
for the first of them its name, type, output shape, largest difference
and the batch positions that differ.  With ``--deterministic`` cuDNN's
deterministic algorithms are asked for as well.  TF32 is off.
"""

from __future__ import annotations

import argparse
import json
import os


def probe(encoder, x, perm):
    import torch

    first, report = {}, []

    def hook(name):
        def fn(mod, args, out):
            if not torch.is_tensor(out) or out.shape[0] != x.shape[0]:
                return
            if name not in first:
                first[name] = out.detach().clone()
                return
            a, b = first.pop(name)[perm], out.detach()
            bad = (a != b).flatten(1).any(1).nonzero().flatten().tolist()
            report.append({"module": name, "type": type(mod).__name__,
                           "shape": list(b.shape), "dtype": str(b.dtype),
                           "max_abs_diff": (a.float() - b.float()).abs().max().item(),
                           "positions": bad})
        return fn

    hooks = [m.register_forward_hook(hook(n)) for n, m in encoder.named_modules() if n]
    try:
        with torch.inference_mode():
            encoder(x)
            encoder(x[perm])
    finally:
        for h in hooks:
            h.remove()
    differ = [r for r in report if r["positions"]]
    return {"compared": len(report), "differing": len(differ),
            "first": differ[0] if differ else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/sd3unet_gq_0.25.yaml")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from vqvae_from_gaussian_vae_tpu_torch import instantiate_from_config, load_config

    if not torch.cuda.is_available():
        raise SystemExit("batch_position_probe runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.deterministic
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cfg = load_config(os.path.join(root, args.config))
    params = cfg["model"]["params"]
    params["loss_config"] = None
    for key in ("encoder_config", "decoder_config"):
        params[key]["params"]["dtype"] = args.dtype
    engine = instantiate_from_config(cfg["model"], seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = args.batch
    x = torch.rand((2 * b, args.res, args.res, 3), generator=gen, device="cuda") * 2 - 1
    perms = {"roll_by_one": (x[:b], torch.roll(torch.arange(b, device="cuda"), 1)),
             "even_first": (x, torch.cat([torch.arange(0, 2 * b, 2),
                                          torch.arange(1, 2 * b, 2)]).cuda())}
    for label, (xs, perm) in perms.items():
        out = probe(engine.encoder, xs, perm)
        print(json.dumps({"permutation": label, "batch": len(xs), "config": args.config,
                          "dtype": args.dtype, "cudnn_deterministic": args.deterministic,
                          "card": torch.cuda.get_device_name(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
