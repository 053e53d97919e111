"""Profiling: a ``torch.profiler`` trace and per-op throughput (PyTorch).

Counterpart of ``imagetransformations_tpu/utils/profiling.py`` (the
reference has no tracing at all, SURVEY.md §5):

- ``trace(log_dir)``: a context manager that records the CPU and, where
  there is a card, the CUDA activity of its body with ``torch.profiler``
  and writes a Chrome trace (``trace.json``) into ``log_dir``.
- ``op_throughput``: the time of one call of an image op and the rates it
  gives. On the card CUDA events time ``k1`` and ``k2`` chained calls; on
  the CPU the wall clock does. The difference of the two runs over
  ``k2 - k1`` cancels the fixed cost of a run (the JAX package scans the op
  inside one compiled call for the same reason).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the body with ``torch.profiler`` (CPU, plus CUDA where
    available) and write ``log_dir/trace.json`` (Chrome trace format) on
    leaving; the profiler object is yielded for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _run_ms(op, x: torch.Tensor, k: int, reps: int = 3) -> float:
    """The best of ``reps`` timings of ``k`` chained ``op`` calls, in ms,
    after one warm-up run."""
    def run():
        y = x
        for _ in range(k):
            y = op(y)
        return y

    run()
    best = float("inf")
    for _ in range(reps):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def op_throughput(
    op: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    k1: int = 4,
    k2: int = 16,
) -> dict:
    """Time of one call of the image-batch op ``op`` on ``x`` (NHWC) and its
    rates: ``{"ms_per_op", "gpix_per_s", "gbytes_per_s"}`` (bytes: one u8
    read and one write a value), on ``x``'s device."""
    per_ms = max((_run_ms(op, x, k2) - _run_ms(op, x, k1)) / (k2 - k1), 1e-6)
    npix = x.shape[0] * x.shape[1] * x.shape[2]
    per_s = per_ms / 1e3
    return {"ms_per_op": per_ms, "gpix_per_s": npix / per_s / 1e9,
            "gbytes_per_s": npix * x.shape[-1] * 2 / per_s / 1e9}
