"""The two-phase GAN training step.

Port of ``vqvae_from_gaussian_vae_tpu/parallel/train_step.py``
(``TrainStepBuilder``).  Phase 0 (``ae_step``) trains the engine and, with
``learn_logvar``, the loss's ``logvar``; phase 1 (``disc_step``) trains the
discriminator on reconstructions made without engine gradients.  The caller
picks the phase and whether the discriminator is active, as the JAX
package's host trainer does.

The adaptive discriminator weight is
``||d nll / d w|| / (||d g / d w|| + 1e-4)``, clamped to [0, 1e4] and
scaled by ``disc_weight``, with w the decoder's last-layer weight only.
The decoder trunk's output h does not depend on w, so both gradients are
taken on the graph the loss builds (``torch.autograd.grad`` with the graph
kept); the JAX package reruns the last layer on a detached h for the same
values.  Gradients are taken with ``torch.autograd.grad`` against the
phase's own parameters, so the other phase's parameters never collect
gradients.

The GQ duals update from each training forward's KL statistics in both
phases.  eps comes from the state's generator or is passed in (``eps=``),
so a test can feed both packages the same numbers.

Data parallelism (``parallel/distributed.py``): each rank computes its
own per-card batch and the step reduces explicitly, to the global-batch
semantics GSPMD gives the JAX step (``autograd.grad`` bypasses
``DistributedDataParallel``'s hooks).  Each phase's gradients are
all-reduced to their mean before the update; the adaptive weight's two
last-layer gradients are all-reduced before their norms; the KL
statistics ``bits-mean``, ``bits-min`` and ``bits-max`` are reduced as
mean, min and max before the dual update, so the duals stay bit-equal on
every rank; the train sample's eps is the joined batch's, this rank's rows
(``noise_rows``).  ``grad_allreduce_dtype`` casts a phase's gradients to
that dtype before the reduce and back after it, for the phases in
``grad_allreduce_phases`` (default the disc phase), less the phases that
already compute in bf16, with the JAX package's warning.  ``mesh``, a mesh
spec, names the data-parallel size: ``None`` every rank of the process
group, ``{"data": 1}`` this rank alone.  The eval step has no collective.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

import torch

from vqvae_from_gaussian_vae_tpu_torch.parallel import distributed
from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import TrainState
from vqvae_from_gaussian_vae_tpu_torch.quantization import gaussian as gq
from vqvae_from_gaussian_vae_tpu_torch.utils.config import as_torch_dtype

STAT_OPS = {"bits-mean": "mean", "bits-min": "min", "bits-max": "max"}


def _dual_config(reg):
    """(log2 codebook, tolerance, lam_factor, lam_range) for the GQ regularizer."""
    if isinstance(reg, gq.GaussianQuantRegularizer):
        return (int(math.log2(reg.n_samples)), reg.tolerance, reg.lam_factor, (1e-3, 1e3))
    return None


class TrainStepBuilder:
    """ae / disc / eval steps for an ``AutoencodingEngine`` built with a loss."""

    def __init__(self, engine, ae_opt, disc_opt, grad_allreduce_dtype=None, mesh=None,
                 grad_allreduce_phases=("disc",)):
        if engine.loss is None:
            raise ValueError("engine was built eval_only / without a loss")
        self.world = distributed.data_parallel_size(mesh)
        self.rank = distributed.rank() if self.world > 1 else 0
        self.grad_allreduce_dtype = (as_torch_dtype(grad_allreduce_dtype)
                                     if grad_allreduce_dtype else None)
        self.grad_allreduce_phases = tuple(grad_allreduce_phases)
        if self.grad_allreduce_dtype is not None:
            # bf16 compute already reduces bf16 partials on the JAX package's
            # backend, where the knob would reduce twice; the same phases drop
            loss_bf16 = engine.loss.dtype == torch.bfloat16
            eng_bf16 = getattr(engine.encoder, "dtype", torch.float32) == torch.bfloat16
            drop = []
            if loss_bf16 and "disc" in self.grad_allreduce_phases:
                drop.append("disc")
            if (loss_bf16 or eng_bf16) and "ae" in self.grad_allreduce_phases:
                drop.append("ae")
            if drop:
                warnings.warn(
                    f"grad_allreduce_dtype: phases {drop} already run bf16 "
                    "compute — their grad collectives ride bf16 natively and "
                    "the knob would double the wire bytes; skipping them")
                self.grad_allreduce_phases = tuple(
                    p for p in self.grad_allreduce_phases if p not in drop)
        self.engine = engine
        self.module = engine.module
        self.loss_mod = engine.loss
        self.ae_opt_spec = ae_opt
        self.disc_opt_spec = disc_opt
        self.dual_cfg = _dual_config(engine.regularization)
        self.last_layer_path = self.module.last_layer_path
        self.last_layer = self.module.get_parameter(self.last_layer_path)

    # ----------------------------------------------------------- parameters

    def ae_named_parameters(self):
        """The phase-0 parameters by reference name: the engine's, and
        ``loss.logvar`` when it is learned."""
        named = [(n, p) for n, p in self.module.named_parameters() if p.requires_grad]
        if self.loss_mod.learn_logvar:
            named.append(("loss.logvar", self.loss_mod.logvar))
        return named

    def disc_named_parameters(self):
        return [("loss.discriminator." + n, p)
                for n, p in self.loss_mod.discriminator.named_parameters()]

    # ----------------------------------------------------------- pieces

    @property
    def noise_rows(self):
        """(rank, world) of this rank's eps rows, or None on one rank."""
        return (self.rank, self.world) if self.world > 1 else None

    def _encode_train(self, x, state: TrainState, eps):
        """encode's train branch, the KL statistics reduced over the ranks."""
        z, reg_log = self.module.encode(x, return_reg_log=True, train=True, duals=state.duals,
                                        generator=state.generator, eps=eps,
                                        noise_rows=self.noise_rows)
        if self.world > 1 and "bits-mean" in reg_log:
            reg_log = dict(reg_log)
            for k, op in STAT_OPS.items():
                reg_log[k] = distributed.all_reduce_scalars({k: reg_log[k]}, op)[k]
        return z, reg_log

    def _forward_split(self, x, state: TrainState, eps):
        """encode (train branch) -> (z, reg_log), decoder trunk h, xrec."""
        z, reg_log = self._encode_train(x, state, eps)
        h = self.module.decode_pre_last_layer(z, train=True)
        return z, reg_log, h, self.module.decode_last_layer(h, train=True)

    def _reduce_grads(self, grads, phase: str):
        """The ranks' mean of each gradient (in place), in
        ``grad_allreduce_dtype`` for the phases it names."""
        dtype = self.grad_allreduce_dtype if phase in self.grad_allreduce_phases else None
        if self.world > 1 or dtype is not None:
            distributed.all_reduce_mean_(grads, dtype=dtype)
        return grads

    def _adaptive_d_weight(self, nll, g):
        w = self.last_layer
        (nll_grad,) = torch.autograd.grad(nll, w, retain_graph=True)
        (g_grad,) = torch.autograd.grad(g, w, retain_graph=True)
        if self.world > 1:  # the global batch's gradients, then their norms
            distributed.all_reduce_mean_([nll_grad, g_grad])
        d_weight = nll_grad.norm() / (g_grad.norm() + 1e-4)
        return torch.clamp(d_weight, 0.0, 1e4).detach() * self.loss_mod.disc_weight

    def _update_duals(self, duals, reg_log):
        if self.dual_cfg is None or "bits-mean" not in reg_log:
            return duals
        log_n, tol, factor, lam_range = self.dual_cfg
        stats = {k: reg_log[k].detach() for k in ("bits-mean", "bits-min", "bits-max")}
        return gq.update_duals(duals, stats, log_n, tol, factor, lam_range)

    @staticmethod
    def _input(batch, device):
        return torch.as_tensor(batch["img"], device=device, dtype=torch.float32)

    # ----------------------------------------------------------- phase 0

    def ae_grads(self, state: TrainState, batch, disc_active: bool,
                 eps: Optional[torch.Tensor] = None):
        """Phase 0's loss and gradients without an update:
        (grads by reference name, log, reg_log)."""
        x = self._input(batch, self.engine.device)
        named = self.ae_named_parameters()
        with torch.enable_grad():
            _, reg_log, _, xrec = self._forward_split(x, state, eps)
            loss, log = self.loss_mod(
                x, xrec, regularization_log=reg_log, optimizer_idx=0, global_step=state.step,
                split="train", d_weight=self._adaptive_d_weight if disc_active else 0.0,
                train=True)
            grads = torch.autograd.grad(loss, [p for _, p in named])
        grads = self._reduce_grads(list(grads), "ae")
        return dict(zip((n for n, _ in named), grads)), log, reg_log

    def ae_step(self, state: TrainState, batch, disc_active: bool,
                eps: Optional[torch.Tensor] = None):
        grads, log, reg_log = self.ae_grads(state, batch, disc_active, eps)
        _apply(state.ae_opt, self.ae_named_parameters(), grads)
        state.duals = self._update_duals(state.duals, reg_log)
        state.step += 1
        return state, log

    # ----------------------------------------------------------- phase 1

    def disc_grads(self, state: TrainState, batch, eps: Optional[torch.Tensor] = None):
        """Phase 1's loss and gradients without an update: the engine
        encodes (train branch, for the sample and the dual statistics) and
        decodes on the inference path (``train=False``), without gradients;
        the discriminator sees x and xrec."""
        x = self._input(batch, self.engine.device)
        with torch.no_grad():
            z, reg_log = self._encode_train(x, state, eps)
            xrec = self.module.decode(z)
        named = self.disc_named_parameters()
        with torch.enable_grad():
            d, log = self.loss_mod(x, xrec, regularization_log={}, optimizer_idx=1,
                                   global_step=state.step, split="train", train=True)
            grads = torch.autograd.grad(d, [p for _, p in named])
        grads = self._reduce_grads(list(grads), "disc")
        return dict(zip((n for n, _ in named), grads)), log, reg_log

    def disc_step(self, state: TrainState, batch, eps: Optional[torch.Tensor] = None):
        grads, log, reg_log = self.disc_grads(state, batch, eps)
        _apply(state.disc_opt, self.disc_named_parameters(), grads)
        state.duals = self._update_duals(state.duals, reg_log)
        state.step += 1
        return state, log

    # ----------------------------------------------------------- eval

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, eps: Optional[torch.Tensor] = None) -> Dict:
        """Validation losses of both phases on the eval forward (GQ search).
        Its eps comes from a copy of the state's generator, which it leaves
        as it was: the JAX step draws from ``fold_in(rng, 17)`` and leaves
        ``rng``, and ranks with shards of different lengths keep one state."""
        x = self._input(batch, self.engine.device)
        generator = torch.Generator(device=state.generator.device)
        generator.set_state(state.generator.get_state())
        _, xrec, reg_log = self.module(x, train=False, duals=state.duals,
                                       generator=generator, eps=eps)
        kw = dict(regularization_log=reg_log, global_step=state.step, split="val", train=False)
        _, log = self.loss_mod(x, xrec, optimizer_idx=0, **kw)
        _, log1 = self.loss_mod(x, xrec, optimizer_idx=1, **kw)
        return {**log, **log1}

    # ----------------------------------------------------------- init

    def init_state(self, seed: int, example_batch, eps: Optional[torch.Tensor] = None
                   ) -> TrainState:
        """ActNorm's data-dependent init on a real batch (the engine's eval
        reconstruction beside it), the optimizers bound to their
        parameters, the duals at 1 and the generator seeded."""
        device = self.engine.device
        x = self._input(example_batch, device)
        generator = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            _, xrec, _ = self.module(x, train=False, generator=generator, eps=eps)
        self.loss_mod.init_actnorm(x, xrec)
        return TrainState(step=0, duals=gq.init_duals(device), generator=generator,
                          ae_opt=self.ae_opt_spec.build(self.ae_named_parameters()),
                          disc_opt=self.disc_opt_spec.build(self.disc_named_parameters()))


def _apply(opt: torch.optim.Optimizer, named, grads: Dict[str, torch.Tensor]) -> None:
    for name, p in named:
        p.grad = grads[name]
    opt.step()
    for _, p in named:
        p.grad = None
