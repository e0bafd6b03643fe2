"""The port's training entry point.

    python -m vqvae_from_gaussian_vae_tpu_torch.main --base configs/sd3unet_gq_0.25.yaml \\
        [configs/overlays/bf16_compute.yaml] [--name run1] [--resume logs/<run>] \\
        [--seed 23] [--logdir logs] [--scale_lr] [--max_steps N] [--no-test] \\
        [--device cuda|cpu] [model.params...=... dotlist overrides]

Port of the root ``main.py``, with the same flags: the ``--base`` configs
merge left to right, then the dotlist overrides, then ``${...}``
interpolation; ``--resume <logdir>`` reloads that run's
``configs/*.yaml`` and continues from its ``checkpoints/last``.  A new run
writes ``<logdir>/<time>_<name>/configs/merged.yaml``.  The ``training:``
section gives the trainer's knobs, and a reference-style ``lightning:``
section is read as well.  ``--profile`` records a ``torch.profiler`` trace
of at most 10 steps into ``<logdir>/trace`` (``utils/profiling.py:trace``);
``--matmul_precision highest`` turns TF32 off for matmuls and cuDNN,
``default`` and ``high`` turn it on.
The engine runs on the CUDA card unless ``--device cpu`` is given.

Data parallel on N cards of one host::

    torchrun --nproc_per_node N -m vqvae_from_gaussian_vae_tpu_torch.main --base ...

runs one process a card (``parallel/distributed.py``): ``--device cuda``
is this rank's card, the backend NCCL with a card a rank and gloo when the
ranks share cards (or with ``--device cpu``).  ``data.params.batch_size``
stays per card, as in the reference's Lightning DDP: a step's joined batch
is N x ``batch_size`` (the JAX trainer on one multi-device host instead
splits one loader batch over its devices).  Rank 0 names the run's log
directory and writes the logs and checkpoints.

``main(argv)`` returns the ``Trainer``, so a caller in the same process can
read what it did; it leaves the process group up for such a caller, and
``python -m`` leaves it at exit.  Importing this module does nothing.
"""

from __future__ import annotations

import argparse
import datetime
import os
from typing import Optional, Sequence


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m vqvae_from_gaussian_vae_tpu_torch.main")
    p.add_argument("-b", "--base", nargs="*", metavar="base_config.yaml", default=[])
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-r", "--resume", type=str, default="", help="resume from logdir")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--scale_lr", action="store_true", help="lr = n_dev*bs*base_lr")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--projectname", type=str, default="vqvae_from_gaussian_vae_tpu")
    p.add_argument("--max_steps", type=int, default=0,
                   help="override training.trainer.max_steps")
    p.add_argument("--no-test", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="a torch.profiler trace of at most 10 steps into <logdir>/trace")
    p.add_argument("--lpips_weights", type=str, default="",
                   help="the reference's vgg.pth LPIPS checkpoint, installed into the "
                        "frozen perceptual loss at init")
    p.add_argument("--matmul_precision", type=str, default="",
                   choices=["", "default", "high", "highest"],
                   help="'highest' turns TF32 off for float32 matmuls and cuDNN convs, "
                        "'default' and 'high' turn it on")
    p.add_argument("--device", type=str, default="cuda",
                   help="the engine's device: cuda (the default; raises without a card) "
                        "or cpu")
    return p


def _set_matmul_precision(precision: str) -> None:
    import torch

    if precision:
        tf32 = precision != "highest"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32


def _trainer_sections(cfg: dict):
    """(trainer knobs, checkpoint config, image logger config) from the
    ``training:`` section, or a reference-style ``lightning:`` one."""
    tcfg = cfg.get("training", {}) or {}
    lcfg = cfg.get("lightning", {}) or {}
    knobs = {**(lcfg.get("trainer", {}) or {}), **(tcfg.get("trainer", {}) or {})}
    ckpt_cfg = tcfg.get("checkpoint") or (lcfg.get("modelcheckpoint", {}) or {}).get(
        "params", {})
    img_cfg = tcfg.get("image_logger") or (
        (lcfg.get("callbacks", {}).get("image_logger", {}) or {}).get("params", {}))
    img_cfg = {k: v for k, v in (img_cfg or {}).items()
               if k in ("batch_frequency", "max_images", "increase_log_steps",
                        "log_first_step", "disabled", "enable_autocast", "log_images_kwargs")}
    return knobs, ckpt_cfg, img_cfg


def main(argv: Optional[Sequence[str]] = None):
    args, unknown = get_parser().parse_known_args(argv)
    if not (args.base or args.resume):
        raise SystemExit("need --base config(s) or --resume")

    from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import resolve_device
    from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed
    from vqvae_from_gaussian_vae_tpu_torch.parallel.trainer import Trainer
    from vqvae_from_gaussian_vae_tpu_torch.utils.config import (
        instantiate_from_config, load_config)

    if distributed.launched():
        device = distributed.maybe_initialize_distributed(args.device)
    else:
        device = resolve_device(None if args.device == "cuda" else args.device)
    writer = distributed.rank() == 0
    _set_matmul_precision(args.matmul_precision)

    resume_dir = ""
    bases = list(args.base)
    if args.resume:
        # the run's own saved configs first, then any further --base
        resume_dir = args.resume
        cfg_dir = os.path.join(resume_dir, "configs")
        if os.path.isdir(cfg_dir):
            bases = sorted(os.path.join(cfg_dir, f) for f in os.listdir(cfg_dir)
                           if f.endswith(".yaml")) + bases
    cfg = load_config(bases, dotlist=unknown)

    if resume_dir:
        logdir = resume_dir
    else:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        cfg_name = os.path.splitext(os.path.basename(bases[0]))[0] if bases else "run"
        logdir = distributed.broadcast_object(
            os.path.join(args.logdir, f"{now}_{args.name or cfg_name}"))
        if writer:
            os.makedirs(os.path.join(logdir, "configs"), exist_ok=True)
            import yaml

            with open(os.path.join(logdir, "configs", "merged.yaml"), "w") as f:
                yaml.safe_dump(cfg, f, sort_keys=False)
        distributed.barrier()

    # the trainer's seed makes the engine's weights unless the config names one
    model_params = cfg["model"].get("params", {}) or {}
    extra = {"device": device}
    if "seed" not in model_params:
        extra["seed"] = args.seed
    engine = instantiate_from_config(cfg["model"], **extra)
    data = instantiate_from_config(cfg["data"])

    knobs, ckpt_cfg, img_cfg = _trainer_sections(cfg)
    trainer = Trainer(
        engine, data, logdir=logdir,
        max_steps=args.max_steps or knobs.get("max_steps", 1_000_000),
        log_every_n_steps=knobs.get("log_every_n_steps", 50),
        val_every_n_steps=knobs.get("val_every_n_steps", 0),
        seed=args.seed, mesh_spec=knobs.get("mesh"),
        accumulate_grad_batches=knobs.get("accumulate_grad_batches", 1),
        scale_lr=args.scale_lr, base_lr=cfg["model"].get("base_learning_rate", 1e-4),
        checkpoint_cfg=ckpt_cfg, image_logger_cfg=img_cfg, use_wandb=args.wandb,
        wandb_project=args.projectname, run_name=os.path.basename(logdir),
        lpips_weights=args.lpips_weights or None)
    if writer:
        print(f"logdir: {logdir}  lr: {trainer.learning_rate}  device: {device}  "
              f"ranks: {distributed.world()} ({distributed.backend() or 'one process'})")
    if args.profile:
        from vqvae_from_gaussian_vae_tpu_torch.utils.profiling import trace

        name = "trace.json" if writer else f"trace_rank{distributed.rank()}.json"
        trainer.max_steps = min(trainer.max_steps, 10)
        with trace(os.path.join(logdir, "trace"), name):
            trainer.fit(resume=bool(resume_dir))
        return trainer
    trainer.fit(resume=bool(resume_dir))
    if not args.no_test:
        trainer.test()
    return trainer


if __name__ == "__main__":
    from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed as _distributed

    main()
    _distributed.shutdown()
