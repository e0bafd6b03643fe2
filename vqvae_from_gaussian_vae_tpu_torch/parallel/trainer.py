"""The training loop: a host loop around the two-phase GAN step.

Port of ``vqvae_from_gaussian_vae_tpu/parallel/trainer.py``.  ``Trainer.fit``
alternates the phases by batch parity (``batch_idx % 2``), forced to the ae
phase before the engine's ``disc_start_iter``; the discriminator term is
active from the loss's ``disc_start``.  It logs scalars (the step's losses,
``duals/*``, ``imgs_per_sec``, ``lr``) every ``log_every_n_steps``, image
grids on the ImageLogger's schedule, validates every ``val_every_n_steps``
(keeping the ``monitor``'s best checkpoints), and checkpoints every
``every_n_train_steps`` (``last``) and every ``keep_every_n_train_steps``
(``step_%08d``, never deleted).  SIGUSR1 asks for a ``last`` checkpoint at
the next step, SIGUSR2 dumps every thread's stack, and a crash writes
``last`` before it re-raises.

A checkpoint is a directory ``checkpoints/<name>/`` holding ``state.pt``
(``torch.save``, read back with ``weights_only=True``): the engine's
weights, the loss head's (LPIPS, ``logvar``, the discriminator with
ActNorm's ``loc`` and ``scale``), both optimizers' states, the duals, the
step and the regularizer's generator.  Resume restores it after
``init_state``'s ActNorm init, as the JAX trainer does, and restarts the
loader and the batch parity.

Data parallel under ``torchrun`` (``parallel/distributed.py``): one
process a card, each loading its own shard of every split
(``shard_id=rank``) at the per-card ``batch_size``, so a step's joined
batch is world x ``batch_size`` and ``scale_lr`` counts the world size.
``init_state``'s ActNorm init runs on the joined first batch, so that N
ranks equal one process on the joined batches.  The logged losses are the
ranks' means; validation reduces once, after its loop, the ranks' sums and
image counts of their batch logs (shards may differ in length, so no
collective runs inside the loop), and logs the image-weighted mean.  Rank
0 writes checkpoints, logs and images, and every rank waits for each
write; every rank reads a checkpoint on resume.  ``mesh_spec``
``{"data": -1 | N}`` is accepted; a ``model`` axis above 1 raises.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import TrainState, make_optimizers
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_step import TrainStepBuilder
from vqvae_from_gaussian_vae_tpu_torch.utils.loggers import CSVLogger, ImageLogger, WandbLogger

STATE_FILE = "state.pt"


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint directory."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def _is_writer() -> bool:
    """Rank 0 writes checkpoints and logs (every rank holds the same state)."""
    return distributed.rank() == 0


class Checkpointer:
    """Rolling ``last``, keep-forever ``step_%08d`` snapshots and the top-k
    ``best_step_%08d`` of a monitored value (with its ``best.json``).
    ``payload(state)`` gives what a checkpoint holds."""

    def __init__(self, logdir: str, payload: Callable[[Any], Dict], every_n: int = 5000,
                 keep_every_n: int = 10000):
        self.dir = os.path.abspath(os.path.join(logdir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.every_n = every_n
        self.keep_every_n = keep_every_n
        self.payload = payload

    def _write(self, state, name: str) -> None:
        path = os.path.join(self.dir, name)
        target = os.path.join(path, STATE_FILE)
        os.makedirs(path, exist_ok=True)
        torch.save(self.payload(state), target + ".tmp")
        os.replace(target + ".tmp", target)

    def save(self, state, name: Optional[str] = None, force: bool = False) -> List[str]:
        if not _is_writer():
            return []
        step = int(state.step)
        if name is not None:
            names = [name]
        else:
            names = []
            if force or (self.every_n and step % self.every_n == 0):
                names.append("last")
            if self.keep_every_n and step and step % self.keep_every_n == 0:
                names.append(f"step_{step:08d}")
        for n in names:
            self._write(state, n)
        return names

    def restore(self, name: str = "last") -> Dict[str, Any]:
        return read_checkpoint(os.path.join(self.dir, name))

    def has(self, name: str = "last") -> bool:
        return os.path.exists(os.path.join(self.dir, name, STATE_FILE))

    def save_best(self, state, value: float, monitor: str, top_k: int = 3,
                  mode: str = "min") -> Optional[str]:
        """Keep the k best snapshots of ``monitor`` (``mode`` min or max)."""
        if not _is_writer():
            return None
        ledger_path = os.path.join(self.dir, "best.json")
        ledger = []
        if os.path.exists(ledger_path):
            with open(ledger_path) as f:
                ledger = json.load(f)
        sign = 1.0 if mode == "min" else -1.0
        if len(ledger) >= top_k and sign * value >= max(sign * e["value"] for e in ledger):
            return None
        name = f"best_step_{int(state.step):08d}"
        self._write(state, name)
        ledger = [e for e in ledger if e["name"] != name]
        ledger.append({"name": name, "value": float(value), "monitor": monitor})
        ledger.sort(key=lambda e: sign * e["value"])
        for e in ledger[top_k:]:
            shutil.rmtree(os.path.join(self.dir, e["name"]), ignore_errors=True)
        ledger = ledger[:top_k]
        with open(ledger_path, "w") as f:
            json.dump(ledger, f, indent=1)
        return name


class Trainer:
    def __init__(self, engine, data_module, logdir: str = "logs/run",
                 max_steps: int = 1_000_000, log_every_n_steps: int = 50,
                 val_every_n_steps: int = 0, seed: int = 23,
                 mesh_spec: Optional[Dict[str, int]] = None, scale_lr: bool = False,
                 base_lr: float = 1e-4, accumulate_grad_batches: int = 1,
                 checkpoint_cfg: Optional[Dict] = None, image_logger_cfg: Optional[Dict] = None,
                 use_wandb: bool = False, wandb_project: str = "vqvae_from_gaussian_vae_tpu",
                 run_name: str = "run", lpips_weights: Optional[str] = None):
        self.world = distributed.data_parallel_size(mesh_spec)
        self.engine = engine
        self.lpips_weights = lpips_weights
        self.data = data_module
        self.logdir = logdir
        self.max_steps = max_steps
        self.log_every = log_every_n_steps
        self.val_every = val_every_n_steps
        self.seed = seed
        os.makedirs(logdir, exist_ok=True)

        # lr = accumulate * cards * per-card batch * base_lr with scale_lr;
        # float() because YAML 1.1 reads "1e-4" as a string
        n_dev = self.world
        base_lr = float(base_lr)
        bs = data_module.batch_size
        lr = base_lr * accumulate_grad_batches * n_dev * bs if scale_lr else base_lr
        self.learning_rate = lr
        engine.learning_rate = lr

        opt_cfg = engine.optimizer_config
        ae_opt, disc_opt = make_optimizers(
            lr,
            opt_cfg if isinstance(opt_cfg, dict) and str(opt_cfg.get("target", "")
                                                          ).startswith("optax") else None,
            accumulate_grad_batches=accumulate_grad_batches,
            lr_g_factor=engine.lr_g_factor,
            trainable_ae_params=engine.trainable_ae_params,
            ae_optimizer_args=engine.ae_optimizer_args,
            trainable_disc_params=engine.trainable_disc_params,
            disc_optimizer_args=engine.disc_optimizer_args)
        self.builder = TrainStepBuilder(engine, ae_opt, disc_opt, mesh=mesh_spec)

        ckpt_cfg = checkpoint_cfg or {}
        self.checkpointer = Checkpointer(
            logdir, self.checkpoint_payload, every_n=ckpt_cfg.get("every_n_train_steps", 5000),
            keep_every_n=ckpt_cfg.get("keep_every_n_train_steps", 10000))
        self.monitor = ckpt_cfg.get("monitor", engine.monitor)
        self.save_top_k = int(ckpt_cfg.get("save_top_k", 3))
        self.monitor_mode = ckpt_cfg.get("mode", "min")
        if self.monitor:
            print(f"Monitoring {self.monitor} as checkpoint metric (top-{self.save_top_k}).")
        self.scalar_logger = CSVLogger(logdir)
        self.wandb = WandbLogger(wandb_project, run_name) if use_wandb else None
        self.image_logger = ImageLogger(**(image_logger_cfg or {}))
        self.state: Optional[TrainState] = None
        self._want_ckpt = False
        try:
            signal.signal(signal.SIGUSR1, self._on_sigusr1)
            signal.signal(signal.SIGUSR2, self._on_sigusr2)
        except ValueError:
            pass  # not in the main thread

    def _on_sigusr1(self, *_):
        self._want_ckpt = True

    def _on_sigusr2(self, *_):
        import faulthandler

        faulthandler.dump_traceback(all_threads=True)

    # ------------------------------------------------------------- state

    def checkpoint_payload(self, state: TrainState) -> Dict[str, Any]:
        """What a checkpoint holds, on the host."""
        cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
        return {"step": int(state.step), "engine": cpu(self.engine.module.state_dict()),
                "loss": cpu(self.engine.loss.state_dict()),
                "ae_opt": state.ae_opt.state_dict(), "disc_opt": state.disc_opt.state_dict(),
                "duals": cpu(state.duals), "generator": state.generator.get_state()}

    def load_payload(self, state: TrainState, blob: Dict[str, Any]) -> TrainState:
        device = self.engine.device
        self.engine.module.load_state_dict(blob["engine"])
        self.engine.loss.load_state_dict(blob["loss"])
        state.ae_opt.load_state_dict(blob["ae_opt"])
        state.disc_opt.load_state_dict(blob["disc_opt"])
        state.duals = {k: v.to(device) for k, v in blob["duals"].items()}
        state.generator.set_state(blob["generator"])
        state.step = int(blob["step"])
        return state

    def _install_lpips_weights(self) -> None:
        """``--lpips_weights`` into the frozen perceptual net; the loss
        loads its own ``lpips_weights`` when it is built.  Warns when the
        perceptual loss runs on seeded weights."""
        from vqvae_from_gaussian_vae_tpu_torch.losses.lpips import load_lpips_weights

        loss = self.engine.loss
        say = print if _is_writer() else (lambda *a, **k: None)
        if self.lpips_weights:
            missing, unexpected = load_lpips_weights(loss.perceptual_loss, self.lpips_weights)
            if missing or unexpected:
                say(f"LPIPS weight load: missing={missing[:5]}... "
                    f"unexpected={unexpected[:5]}...")
            say(f"installed LPIPS weights from {self.lpips_weights}")
        elif not loss.lpips_weights and loss.perceptual_weight > 0:
            say("WARNING: perceptual_weight > 0 but no LPIPS weights configured - "
                "training will use a RANDOMLY-INITIALIZED perceptual net. Set "
                "model.params.loss_config.params.lpips_weights (or --lpips_weights) "
                "to the reference's vgg.pth.")

    def _init_or_resume(self, example_batch, resume: bool) -> TrainState:
        """ActNorm's init on the ranks' first batches joined in rank order."""
        joined = example_batch["img"]
        if self.world > 1:
            joined = distributed.all_gather_rows(np.asarray(joined))
        state = self.builder.init_state(self.seed, {"img": joined})
        self._install_lpips_weights()
        if resume and self.checkpointer.has("last"):
            state = self.load_payload(state, self.checkpointer.restore("last"))
            if _is_writer():
                print(f"resumed from step {state.step}")
        return state

    # ------------------------------------------------------------- loop

    def _log_images(self, batch, step: int) -> None:
        from vqvae_from_gaussian_vae_tpu_torch.losses.discriminator_loss import (
            visualize_disc_logits)

        n = self.image_logger.max_images
        x_small = torch.as_tensor(batch["img"][:n], device=self.engine.device)
        _, xrec, _ = self.engine.forward(x_small)
        extra = visualize_disc_logits(self.engine.loss, x_small, xrec)
        grids = self.image_logger.log_images(self.engine, batch, step, self.logdir,
                                             extra_images=extra)
        if self.wandb:
            self.wandb.log_images(grids, step)

    def _shard(self) -> Dict[str, int]:
        """This rank's loader shard."""
        if self.world == 1:
            return {}
        return {"shard_id": distributed.rank(), "num_shards": self.world}

    def _save(self, name: Optional[str] = None, force: bool = False) -> None:
        """A checkpoint by rank 0, the other ranks waiting for it."""
        self.checkpointer.save(self.state, name=name, force=force)
        distributed.barrier()

    def _log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if _is_writer():
            self.scalar_logger.log(scalars, step)
            if self.wandb:
                self.wandb.log(scalars, step)

    def fit(self, resume: bool = False) -> TrainState:
        loader = self.data.train_dataloader(**self._shard())
        val_loader = None
        if self.val_every and "validation" in self.data.dataset_configs:
            val_loader = self.data.val_dataloader(**self._shard())
        it = iter(loader)
        first = next(it)
        self.state = self._init_or_resume(first, resume)
        loss = self.engine.loss
        disc_start = max(self.engine.disc_start_iter, 0)

        t0 = time.time()
        imgs_seen = 0
        batch_idx = 0
        batch = first
        try:
            while self.state.step < self.max_steps:
                step = self.state.step
                optimizer_idx = batch_idx % 2 if step >= disc_start else 0
                x = {"img": batch["img"]}
                if optimizer_idx == 0:
                    self.state, log = self.builder.ae_step(
                        self.state, x, disc_active=step >= loss.disc_start)
                else:
                    self.state, log = self.builder.disc_step(self.state, x)
                imgs_seen += batch["img"].shape[0] * self.world  # the joined batch
                batch_idx += 1

                if step % self.log_every == 0:
                    log = distributed.all_reduce_scalars(log, "mean")
                    scalars = {k: float(v) for k, v in log.items()}
                    for dk, dv in self.state.duals.items():
                        scalars[f"duals/{dk}"] = float(dv)
                    scalars["imgs_per_sec"] = imgs_seen / max(time.time() - t0, 1e-9)
                    scalars["lr"] = self.learning_rate
                    self._log_scalars(scalars, step)
                if self.image_logger.should_log(step):
                    if _is_writer():
                        self._log_images(batch, step)
                    distributed.barrier()
                self._save()
                if self._want_ckpt:
                    self._save(name="last", force=True)
                    self._want_ckpt = False
                if val_loader is not None and step and step % self.val_every == 0:
                    self.validate(val_loader)
                try:
                    batch = next(it)
                except StopIteration:
                    it = iter(loader)
                    batch = next(it)
        except BaseException:
            import socket

            print(f"crash on host {socket.gethostname()} at step "
                  f"{self.state.step if self.state is not None else '?'}; writing last")
            if self.state is not None:  # no barrier: another rank may be gone
                self.checkpointer.save(self.state, name="last", force=True)
            raise
        self._save(name="last", force=True)
        return self.state

    def validate(self, loader, max_batches: Optional[int] = 50) -> Dict[str, float]:
        """The image-weighted mean of each batch log over this rank's first
        ``max_batches`` batches and, under data parallelism, every rank's:
        the sums and image counts are reduced once, after the loop."""
        sums: Dict[str, float] = {}
        count = 0
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            n = len(batch["img"])
            for k, v in self.builder.eval_step(self.state, {"img": batch["img"]}).items():
                sums[k] = sums.get(k, 0.0) + n * float(v)
            count += n
        if self.world > 1:
            ranks = distributed.all_gather_object((sums, count))
            keys = next((s for s, _ in ranks if s), {})
            sums = {k: sum(s[k] for s, _ in ranks if s) for k in keys}
            count = sum(c for _, c in ranks)
        if not count:
            return {}
        mean = {k: v / count for k, v in sums.items()}
        self._log_scalars(mean, self.state.step)
        if _is_writer():
            print({k: round(v, 5) for k, v in sorted(mean.items())[:8]})
        if self.monitor and self.monitor in mean:
            saved = self.checkpointer.save_best(self.state, mean[self.monitor], self.monitor,
                                                top_k=self.save_top_k, mode=self.monitor_mode)
            distributed.barrier()
            if saved:
                print(f"saved {saved} ({self.monitor}={mean[self.monitor]:.5f})")
        return mean

    def test(self, loader=None) -> Dict[str, float]:
        """A whole validation epoch after fit, logged under the same keys."""
        if loader is None:
            if "test" in self.data.dataset_configs:
                loader = self.data.test_dataloader(**self._shard())
            elif "validation" in self.data.dataset_configs:
                loader = self.data.val_dataloader(**self._shard())
            else:
                return {}
        return self.validate(loader, max_batches=None)
