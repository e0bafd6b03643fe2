"""The port's reconstruction-metric sweep.

    python -m vqvae_from_gaussian_vae_tpu_torch.eval --base configs/sd3unet_gq_0.25.yaml \\
        --ckpt model.pt --dataset /path/to/images --img_size 256 --bs 16 \\
        [--dtype bfloat16] [--inception_weights pt_inception.pth] \\
        [--lpips_weights alex.pth] [--stats_cache stats.npz] [--limit N] \\
        [--save True --save_dir out] [--device cuda|cpu]
    torchrun --nproc_per_node N -m vqvae_from_gaussian_vae_tpu_torch.eval ...

Port of the root ``eval.py`` for images.  Each image is encoded (the GQ
search) and decoded; rank 0 prints PSNR, SSIM, MS-SSIM and LPIPS (AlexNet)
as mean (±std), FID between the source and reconstructed images'
InceptionV3 pool features (the source statistics from ``--stats_cache``
when the file exists, written there when it does not), and the codebook's
usage and entropy over the 2^16 codes.  ``--dtype bfloat16`` runs the
engine's backbones in bf16 and so the hand-written inference kernels.
A config whose target is a frozen baseline VAE
(``pit.models.autoencoder.AutoencoderKLFLUX``, SD3, EQ, HYImage2, HYImage3:
``models/third_party.py``) runs in protocol mode, as the root ``eval.py``
does: the wrapper's ``encode`` gives ``(z, {})`` and ``decode(z)`` the
reconstruction, with no indices and so no codebook histogram.

``--video`` reads ``--dataset`` as a folder of clips (GIF; MP4 with
``imageio``) of ``--num_frames`` frames (``data/video.py``): each batch of
clips folds into one batch of frames for the tokenizer, which reconstructs
frames one by one, and the per-frame metrics and FID run over every frame.
``--fvd`` adds the FVD between the source and the reconstructed clips over
I3D logits (``evaluations/i3d.py``, frames resized to 224; at least 9
frames; ``--i3d_weights`` a pytorch-i3d ``state_dict``, else seeded with a
warning).  As in the root ``eval.py``, ``--save`` with ``--video`` and
``--fvd`` on more than one rank are refused.

Under ``torchrun`` each rank sweeps its own shard of the folder at the
per-card ``--bs`` (``parallel/distributed.py``) and the per-image rows and
features are gathered to every rank in rank order, as the JAX sweep's
``process_allgather`` does; ``--save`` writes each rank's own images.
The metric nets run in float32 with TF32 off (cuDNN's default would move
FID off the JAX package's float32); the flags are restored after the
sweep.  Inception and LPIPS load ``--inception_weights`` and
``--lpips_weights`` with ``strict=True``; without them they run on seeded
weights, with a warning, and only relative comparisons mean anything.
``--dist-backend`` is accepted for
the reference's command lines and ignored: the backend follows the cards.

``main(argv)`` returns the sweep's gathered arrays and summary, so a
caller in the same process can read them.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, Optional, Sequence

import numpy as np

N_CODES = 65536  # the histogram's bins, the JAX sweep's


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m vqvae_from_gaussian_vae_tpu_torch.eval")
    p.add_argument("--base", default="", type=str, help="model config yaml")
    p.add_argument("--ckpt", default="", type=str,
                   help="the engine's weights: a state_dict, a Lightning .ckpt or a trainer "
                        "checkpoint directory")
    p.add_argument("--dataset", default="", type=str, help="image folder or .txt list")
    p.add_argument("--img_size", default=256, type=int)
    p.add_argument("--bs", default=1, type=int, help="per-card batch size")
    p.add_argument("--save", default=False, type=bool)
    p.add_argument("--save_dir", default="", type=str)
    p.add_argument("--limit", default=0, type=int, help="cap on total images (0 = all)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="engine backbone compute dtype; bfloat16 runs the inference kernels")
    p.add_argument("--inception_weights", default="", type=str)
    p.add_argument("--lpips_weights", default="", type=str)
    p.add_argument("--video", action="store_true",
                   help="treat --dataset as a folder of clips (GIF/MP4): per-frame metrics, "
                        "optionally FVD (--fvd)")
    p.add_argument("--num_frames", default=16, type=int, help="frames per clip (video mode)")
    p.add_argument("--fvd", action="store_true",
                   help="also compute FVD over I3D features (needs --num_frames >= 9)")
    p.add_argument("--i3d_weights", default="", type=str,
                   help="a pytorch-i3d state_dict (video mode FVD)")
    p.add_argument("--stats_cache", default="", type=str,
                   help=".npz path caching the source dataset's Inception (mu, sigma)")
    p.add_argument("--dist-backend", default="", type=str,
                   help="accepted and ignored: NCCL with a card a rank, else gloo")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default: this rank's card; raises without one) or cpu")
    return p


@contextlib.contextmanager
def float32_math():
    """TF32 off for matmuls and cuDNN inside, the flags restored after."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def metrics_of(img, rec, inception, lpips) -> Dict:
    """Per-image rows of one batch: PSNR, SSIM, MS-SSIM, LPIPS and both
    images' Inception pool features."""
    from vqvae_from_gaussian_vae_tpu_torch.evaluations.psnr import get_psnr
    from vqvae_from_gaussian_vae_tpu_torch.evaluations.ssim import get_ssim_and_msssim

    ssim_v, msssim_v = get_ssim_and_msssim(img, rec, zero_mean=True)
    (feat_x,) = inception(img)
    (feat_r,) = inception(rec)
    return {"psnr": get_psnr(img, rec, zero_mean=True), "ssim": ssim_v, "msssim": msssim_v,
            "lpips": lpips(img, rec), "feat_x": feat_x[:, 0, 0, :],
            "feat_r": feat_r[:, 0, 0, :]}


def _engine(args, device):
    from vqvae_from_gaussian_vae_tpu_torch.utils.config import (
        instantiate_from_config, load_config)

    cfg = load_config(args.base)
    params_cfg = cfg["model"].setdefault("params", {})
    if "loss_config" in params_cfg:
        params_cfg["loss_config"] = None
    params_cfg.pop("ckpt_path", None)
    if args.dtype != "float32":
        for key in ("encoder_config", "decoder_config"):
            if isinstance(params_cfg.get(key), dict):
                params_cfg[key].setdefault("params", {})["dtype"] = args.dtype
    engine = instantiate_from_config(cfg["model"], device=device)
    if args.ckpt:
        engine.load_checkpoint(args.ckpt)
    return engine


def _save_images(batch, rec, save_dir: str) -> None:
    from PIL import Image

    for b, fpath in enumerate(batch["fpath"]):
        fname = fpath.split("/")[-1] + ".png"
        for arr, sub in ((batch["img"][b], "src"), (rec[b], "rec")):
            u8 = np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)
            Image.fromarray(u8).save(os.path.join(save_dir, sub, fname))


def _video_guards(args, world: int) -> None:
    """The root ``eval.py``'s refusals of video mode."""
    from vqvae_from_gaussian_vae_tpu_torch.evaluations.i3d import MIN_FRAMES

    if args.video and args.save:
        raise SystemExit("--save writes per-image PNGs; not supported with --video")
    if args.video and args.fvd:
        if world > 1:
            raise SystemExit("--video --fvd gathers clip features on one rank; run one process")
        if args.num_frames < MIN_FRAMES:
            raise SystemExit(f"FVD's I3D trunk needs >= {MIN_FRAMES} frames per clip "
                             "(temporal stride 8 plus the final window-2 pool)")


def _i3d(args, device):
    """The FVD feature function: I3D on ``--i3d_weights`` (else seeded, with
    a warning), frames resized to 224."""
    import torch

    from vqvae_from_gaussian_vae_tpu_torch.evaluations.i3d import make_i3d_feature_fn

    sd = (torch.load(args.i3d_weights, map_location="cpu", weights_only=True)
          if args.i3d_weights else None)
    return make_i3d_feature_fn(sd, resize=True, device=device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = get_parser().parse_args(argv)
    if not (args.base and args.dataset):
        raise SystemExit("need --base and --dataset")

    import torch

    from vqvae_from_gaussian_vae_tpu_torch.data.dataset import SimpleDataset, _PrefetchLoader
    from vqvae_from_gaussian_vae_tpu_torch.evaluations.fid import calculate_frechet_distance
    from vqvae_from_gaussian_vae_tpu_torch.evaluations import inception as inception_mod
    from vqvae_from_gaussian_vae_tpu_torch.evaluations.lpips_metric import LPIPSMetric
    from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import resolve_device
    from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed

    if distributed.launched():
        device = distributed.maybe_initialize_distributed(args.device)
    else:
        device = resolve_device(None if args.device == "cuda" else args.device)
    rank, world = distributed.rank(), distributed.world()
    say = print if rank == 0 else (lambda *a, **k: None)
    _video_guards(args, world)

    engine = _engine(args, device)
    if args.video:
        from vqvae_from_gaussian_vae_tpu_torch.data.video import VideoDataset

        dataset = VideoDataset(args.dataset, image_size=args.img_size,
                               num_frames=args.num_frames)
    else:
        dataset = SimpleDataset(args.dataset, image_size=args.img_size)
    loader = _PrefetchLoader(dataset, args.bs, shuffle=False, drop_last=True, shard_id=rank,
                             num_shards=world)

    inception = inception_mod.InceptionV3(output_blocks=(3,), resize_input=True,
                                          normalize_input=False)
    if args.inception_weights:
        inception_mod.load_inception_weights(inception, args.inception_weights)
    else:
        inception_mod.seed_weights(inception, 1)
        say("WARNING: no --inception_weights; FID uses random-weight features")
    inception.to(device).eval()
    lpips = LPIPSMetric("alex", weights_path=args.lpips_weights or None, device=device)
    if not args.lpips_weights:
        say("WARNING: no --lpips_weights; LPIPS uses random-weight features")
    i3d_fn = _i3d(args, device) if args.video and args.fvd else None

    if args.save:
        for sub in ("src", "rec"):
            os.makedirs(os.path.join(args.save_dir, sub), exist_ok=True)
    # the JAX sweep stops once its global count of images (frames) reaches --limit
    per_batch = args.bs * world * (args.num_frames if args.video else 1)
    max_batches = -(-args.limit // per_batch) if args.limit else None
    acc = {k: [] for k in ("psnr", "ssim", "msssim", "lpips", "feat_x", "feat_r")}
    fvd_real, fvd_fake = [], []
    hist = torch.zeros(N_CODES, dtype=torch.int64, device=device)
    with float32_math(), torch.inference_mode():
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            if args.video:  # clips -> one batch of frames
                vid = batch["video"]
                batch = dict(batch, img=vid.reshape((-1,) + vid.shape[2:]))
            img = torch.as_tensor(batch["img"], device=device)
            z, info = engine.encode(img, return_reg_log=True)
            rec = engine.decode(z).float()
            out = metrics_of(img, rec, inception, lpips)
            if i3d_fn is not None:
                fvd_real.append(i3d_fn(vid))
                fvd_fake.append(i3d_fn(rec.reshape(vid.shape)))
            for k in acc:
                acc[k].append(out[k].float().cpu().numpy())
            if info.get("indices") is not None:  # the Gaussian regularizer has no codes
                idx = info["indices"].reshape(-1).long()
                if int(idx.max()) < N_CODES:
                    hist += torch.bincount(idx, minlength=N_CODES)
            if args.save:
                _save_images(batch, rec.cpu().numpy(), args.save_dir)
            if i % 20 == 0:
                say(f"\r{(i + 1) * per_batch} images", end="", flush=True)

    local = {k: (np.concatenate(v) if v else np.zeros((0,) + ((2048,) if "feat" in k else ()),
                                                         np.float32)) for k, v in acc.items()}
    cat = {k: distributed.all_gather_rows(v) for k, v in local.items()}
    hist = distributed.all_gather_rows(hist.cpu().numpy()[None]).sum(0)
    total = len(cat["psnr"])

    result = {**cat, "hist": hist, "count": total, "world": world}
    say(f"\nevaluated {total} images on {world} device(s)")
    say(f"PSNR: {cat['psnr'].mean():.4f} (±{cat['psnr'].std():.4f})")
    say(f"SSIM: {cat['ssim'].mean():.4f} (±{cat['ssim'].std():.4f})")
    say(f"MS-SSIM: {np.nanmean(cat['msssim']):.4f} (±{np.nanstd(cat['msssim']):.4f})")
    say(f"LPIPS (AlexNet): {cat['lpips'].mean():.4f} (±{cat['lpips'].std():.4f})")
    if rank == 0:
        m1, s1 = cat["feat_r"].mean(0), np.cov(cat["feat_r"], rowvar=False)
        if args.stats_cache and os.path.exists(args.stats_cache):
            blob = np.load(args.stats_cache)
            m2, s2 = blob["mu"], blob["sigma"]
            say(f"(source stats from {args.stats_cache})")
        else:
            m2, s2 = cat["feat_x"].mean(0), np.cov(cat["feat_x"], rowvar=False)
            if args.stats_cache:
                np.savez(args.stats_cache, mu=m2, sigma=s2)
                say(f"(source stats cached to {args.stats_cache})")
        result["fid"] = calculate_frechet_distance(m1, s1, m2, s2)
        say(f"FID: {result['fid']:.4f}")
    if fvd_real:
        from vqvae_from_gaussian_vae_tpu_torch.evaluations.fvd import fvd_from_features

        result["fvd"] = fvd_from_features(np.concatenate(fvd_real), np.concatenate(fvd_fake))
        say(f"FVD: {result['fvd']:.4f}")
    if hist.sum() > 0:
        usage = (hist > 0).mean()
        p = hist / hist.sum()
        ent = -(p * np.log2(p + 1e-12)).sum()
        result.update(usage=float(usage), entropy=float(ent))
        say(f"codebook usage: {usage * 100:.2f}%  entropy: {ent:.2f} bits")
    distributed.barrier()  # the stats cache is written before any rank goes on
    return result


if __name__ == "__main__":
    from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed as _distributed

    main()
    _distributed.shutdown()
