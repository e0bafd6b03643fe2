"""Tracing and profiling hooks.

Port of ``vqvae_from_gaussian_vae_tpu/utils/profiling.py``: ``trace`` records
a ``torch.profiler`` trace of the enclosed block (host activity, and the
card's kernels where there is one) and writes it into ``logdir`` as a
Chrome trace (``chrome://tracing`` or Perfetto read it); ``PhaseTimer``
sums wall-clock per named phase, each ended by a ``torch.cuda.synchronize``
of the phase's value's card, and reports ``time/{name}_ms``; ``StepRate`` is
an items-per-second EMA.  The port's ``main.py --profile`` runs its steps
under ``trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, filename: str = "trace.json"):
    """A ``torch.profiler`` trace of the enclosed block, written to
    ``logdir/filename`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, filename))


def _first_tensor(value) -> Optional[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return value
    items = value.values() if isinstance(value, dict) else (
        value if isinstance(value, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class PhaseTimer:
    """Wall-clock per named phase; a phase given a ``sync_value`` (a tensor
    or a nest of them) waits for its card before the clock stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            tensor = None if sync_value is None else _first_tensor(sync_value)
            if tensor is not None and tensor.is_cuda:
                torch.cuda.synchronize(tensor.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {f"time/{k}_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}


class StepRate:
    """Items per second, an EMA over ticks."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._t: Optional[float] = None
        self.rate = 0.0

    def tick(self, n_items: int) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = n_items / max(now - self._t, 1e-9)
            self.rate = inst if self.rate == 0 else (
                self.alpha * inst + (1 - self.alpha) * self.rate)
        self._t = now
        return self.rate
