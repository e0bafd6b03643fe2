"""Train state and optimizers for the two-optimizer GAN step.

Port of ``vqvae_from_gaussian_vae_tpu/parallel/train_state.py``.  The
parameters live in the engine's modules, as PyTorch keeps them; the state
holds what else a step reads and writes: the step counter (the reference's
global_step), the GQ dual variables (three float32 tensors on the device),
the ``torch.Generator`` the regularizer draws its eps from, and the two
optimizers.

``make_optimizers`` returns two ``OptimizerSpec``s, bound to parameters by
``TrainStepBuilder.init_state``: ``torch.optim.Adam`` for the one target
ported, ``optax.adam``, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)
and its ``b1``/``b2``/``eps`` arguments; the generator's learning rate scaled by
``lr_g_factor``, and optional regex parameter groups over the reference's
parameter names (``encoder.*``, ``loss.logvar``, ``loss.discriminator.*``,
matched with ``re.match``; the first group that matches wins, and a
parameter no group matches is frozen), each group with its own arguments.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# optax.adam's arguments that torch.optim.Adam takes, as the torch keyword
_ADAM_ARGS = ("lr", "b1", "b2", "eps")


def _adam_kwargs(args: Dict) -> Dict:
    """optax.adam keyword arguments (and a group's ``lr``) -> torch.optim.Adam's."""
    unknown = set(args) - set(_ADAM_ARGS)
    if unknown:
        raise NotImplementedError(f"optax.adam arguments {sorted(unknown)} are not ported")
    out = {k: args[k] for k in ("lr", "eps") if k in args}
    if "b1" in args or "b2" in args:
        out["betas"] = (float(args.get("b1", 0.9)), float(args.get("b2", 0.999)))
    return out


@dataclasses.dataclass
class OptimizerSpec:
    """An optimizer not yet bound to parameters."""

    lr: float
    kwargs: Dict
    parameter_names: Optional[Sequence[Sequence[str]]] = None
    optimizer_args: Optional[Sequence[Dict]] = None

    def groups(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]]) -> List[Dict]:
        """Parameter groups: all parameters, or one group per regex list
        (unmatched parameters are frozen: in no group)."""
        if self.parameter_names is None:
            return [{"params": [p for _, p in named_params]}]
        args = list(self.optimizer_args or [{} for _ in self.parameter_names])
        if len(args) != len(self.parameter_names):
            raise ValueError("optimizer_args must pair 1:1 with trainable param groups")
        regs = [[re.compile(p) for p in pats] for pats in self.parameter_names]
        members: List[List[torch.nn.Parameter]] = [[] for _ in regs]
        for name, p in named_params:
            for i, pats in enumerate(regs):
                if any(r.match(name) for r in pats):
                    members[i].append(p)
                    break
        groups = []
        for i, params in enumerate(members):
            if params:
                group = _adam_kwargs(dict(args[i] or {}))
                group["params"] = params
                groups.append(group)
        return groups

    def build(self, named_params) -> torch.optim.Optimizer:
        named_params = list(named_params)
        groups = self.groups(named_params)
        if not groups:
            groups = [{"params": []}]
        return torch.optim.Adam(groups, lr=self.lr, **self.kwargs)


def make_optimizers(learning_rate: float, optimizer_config: Optional[Dict] = None,
                    accumulate_grad_batches: int = 1, lr_g_factor: float = 1.0,
                    trainable_ae_params=None, ae_optimizer_args=None,
                    trainable_disc_params=None, disc_optimizer_args=None):
    """(ae spec, disc spec), as the JAX package's ``make_optimizers``."""
    if accumulate_grad_batches > 1:
        raise NotImplementedError("accumulate_grad_batches > 1 waits for the trainer slice "
                                  "of the port (ROADMAP A10)")
    cfg = optimizer_config or {"target": "optax.adam"}
    if cfg["target"] != "optax.adam":
        raise NotImplementedError(f"optimizer target {cfg['target']!r} has no counterpart in "
                                  "the port; only optax.adam (torch.optim.Adam) is ported")
    kwargs = _adam_kwargs(dict(cfg.get("params", {})))
    g_lr = float(lr_g_factor if lr_g_factor is not None else 1.0) * learning_rate
    ae = OptimizerSpec(g_lr, kwargs, trainable_ae_params, ae_optimizer_args)
    disc = OptimizerSpec(learning_rate, kwargs, trainable_disc_params, disc_optimizer_args)
    return ae, disc


@dataclasses.dataclass
class TrainState:
    step: int                         # the reference's global_step
    duals: Dict[str, torch.Tensor]    # GQ lam / lam_min / lam_max, float32 on the device
    generator: torch.Generator        # the regularizer's eps
    ae_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
