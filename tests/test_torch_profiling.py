"""The port's profiling hooks (``utils/profiling.py``) on the CPU: ``trace``
writes a Chrome trace of the enclosed block's operators; ``PhaseTimer`` and
``StepRate`` give the JAX package's numbers under the same patched
``time.perf_counter`` (the phase summary's ``time/{name}_ms`` keys, the
EMA's first and later ticks)."""

import itertools
import json
import time

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.utils import profiling as jax_profiling
from vqvae_from_gaussian_vae_tpu_torch.utils import profiling

CLOCK = (0.0, 0.25, 1.0, 1.125, 2.0, 2.5, 3.0, 3.0625, 5.0, 5.5, 7.25, 8.0)


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace"), "run.json") as prof:
        (a @ a).sum()
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "run.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::sum" in names
    with profiling.trace(str(tmp_path / "trace")):  # the default name
        torch.ones(3).add_(1)
    assert (tmp_path / "trace" / "trace.json").exists()


def _run_phases(mod, value, monkeypatch):
    ticks = itertools.chain(CLOCK)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timer = mod.PhaseTimer()
    for name in ("ae", "disc", "ae", "eval"):
        with timer.phase(name, sync_value=value):
            pass
    with pytest.raises(KeyError):
        with timer.phase("failed"):
            raise KeyError("the phase's time is kept all the same")
    return timer.summary(), timer.counts


def test_phase_timer_matches_jax(monkeypatch):
    got = _run_phases(profiling, {"loss": [torch.ones(2)], "step": 3}, monkeypatch)
    want = _run_phases(jax_profiling, {"loss": [jnp.ones(2)]}, monkeypatch)
    assert got == want
    assert got[0]["time/ae_ms"] == pytest.approx(1e3 * (0.25 + 0.5) / 2)
    assert set(got[0]) == {"time/ae_ms", "time/disc_ms", "time/eval_ms", "time/failed_ms"}


def _rates(mod, monkeypatch):
    ticks = itertools.chain(CLOCK)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    meter = mod.StepRate(alpha=0.3)
    return [meter.tick(n) for n in (16, 16, 32, 8, 16, 16)], meter.rate


def test_step_rate_matches_jax(monkeypatch):
    got = _rates(profiling, monkeypatch)
    assert got == _rates(jax_profiling, monkeypatch)
    assert got[0][0] == 0.0 and got[0][1] == 16 / 0.25


def test_phase_timer_syncs_only_a_card_tensor(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    timer = profiling.PhaseTimer()
    with timer.phase("cpu", sync_value=(torch.zeros(1),)):
        pass
    with timer.phase("none"):
        pass
    assert synced == [] and timer.counts == {"cpu": 1, "none": 1}
