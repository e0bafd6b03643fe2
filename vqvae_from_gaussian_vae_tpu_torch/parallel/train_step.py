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
so a test can feed both packages the same numbers.  One card has no
collective: ``grad_allreduce_dtype`` and ``mesh`` raise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from vqvae_from_gaussian_vae_tpu_torch.parallel.train_state import TrainState
from vqvae_from_gaussian_vae_tpu_torch.quantization import gaussian as gq


def _dual_config(reg):
    """(log2 codebook, tolerance, lam_factor, lam_range) for the GQ regularizer."""
    if isinstance(reg, gq.GaussianQuantRegularizer):
        return (int(math.log2(reg.n_samples)), reg.tolerance, reg.lam_factor, (1e-3, 1e3))
    return None


class TrainStepBuilder:
    """ae / disc / eval steps for an ``AutoencodingEngine`` built with a loss."""

    def __init__(self, engine, ae_opt, disc_opt, grad_allreduce_dtype=None, mesh=None):
        if engine.loss is None:
            raise ValueError("engine was built eval_only / without a loss")
        if grad_allreduce_dtype is not None or mesh is not None:
            raise NotImplementedError("one card has no collective: grad_allreduce_dtype and "
                                      "mesh wait for the data-parallel slice of the port")
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

    def _forward_split(self, x, state: TrainState, eps):
        """encode (train branch) -> (z, reg_log), decoder trunk h, xrec."""
        z, reg_log = self.module.encode(x, return_reg_log=True, train=True, duals=state.duals,
                                        generator=state.generator, eps=eps)
        h = self.module.decode_pre_last_layer(z, train=True)
        return z, reg_log, h, self.module.decode_last_layer(h, train=True)

    def _adaptive_d_weight(self, nll, g):
        w = self.last_layer
        (nll_grad,) = torch.autograd.grad(nll, w, retain_graph=True)
        (g_grad,) = torch.autograd.grad(g, w, retain_graph=True)
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
            z, reg_log = self.module.encode(x, return_reg_log=True, train=True,
                                            duals=state.duals, generator=state.generator,
                                            eps=eps)
            xrec = self.module.decode(z)
        named = self.disc_named_parameters()
        with torch.enable_grad():
            d, log = self.loss_mod(x, xrec, regularization_log={}, optimizer_idx=1,
                                   global_step=state.step, split="train", train=True)
            grads = torch.autograd.grad(d, [p for _, p in named])
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
        """Validation losses of both phases on the eval forward (GQ search)."""
        x = self._input(batch, self.engine.device)
        _, xrec, reg_log = self.module(x, train=False, duals=state.duals,
                                       generator=state.generator, eps=eps)
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
