"""Device time of a call on the card, by CUDA events."""

from __future__ import annotations

import torch

SLEEP_CYCLES = 100_000_000  # about 50 ms at the H100's 1.98 GHz boost clock


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls.

    The calls are queued behind a device sleep of about 50 ms, so the host
    has enqueued them before the first one starts and the events time the
    device's work: a LayerNorm launch takes less device time than its
    Python wrapper takes on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def best_ms(fn, trials: int = 3, iters: int = 10) -> float:
    """The least of `trials` ``time_ms`` means of `iters` calls (one warm-up
    call before the first trial)."""
    return min(time_ms(fn, iters=iters, warmup=1 if t == 0 else 0) for t in range(trials))
