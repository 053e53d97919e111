"""The window of the on-device augmentation kinds (``apply_all_kind``,
``chain_kind``): calls dispatched back to back with no synchronise inside
the window, a CUDA event recorded after each.

A kind gives an entry class (a subclass of ``Calls``) that says what one
call is: the port's call, the outputs it returns, the work it needs, and
the reference's outputs for the calls the window sampled. This module runs
the rest, the same for every such kind.

Traffic parameters read here: ``images_per_call``, ``kernels`` (launch
counters that must move in the window on the card), ``compare_calls``
(how many of the window's calls the reference recomputes: a sample drawn
from the seed as the calls complete), ``trace_calls`` and ``host_calls``
(the traced stretch, and the calls timed one at a time after a
synchronise).

``correct`` holds every output of the sampled calls against the
reference's, byte for byte (``max_lsb``), and each named launch counter
against 1."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from harness import inputs, trace
from harness.check import Checks, lsb_gap
from harness.roofline import least_time_s


class Calls:
    """One kind's call over ``images_per_call``-image slices of the set,
    cycled. Subclasses set ``port(xb, g)`` in ``__init__`` and give
    ``outputs``, ``drawn``, ``work`` and ``reference``."""

    def __init__(self, r, x: torch.Tensor):
        self.r, self.x, self.tr = r, x, r.traffic
        self.per_call = min(int(self.tr["images_per_call"]), x.shape[0])
        self.slices = max(1, x.shape[0] // self.per_call)

    def batch(self, i: int) -> torch.Tensor:
        a = (i % self.slices) * self.per_call
        return self.x[a: a + self.per_call]

    def outputs(self, out) -> dict:
        """{output name: u8 images} of one call's result."""
        raise NotImplementedError

    def drawn(self, out):
        """What ``work`` needs of a call's result (its drawn values), small
        enough to hold for every traced call."""
        return None

    def work(self, i: int, drawn) -> tuple[float, float]:
        """(bytes, flops) of call ``i`` (``harness.roofline``)."""
        raise NotImplementedError

    def reference(self, picked: list, dtype=torch.float32) -> dict:
        """{call: {output name: u8 images}} of the picked calls, computed by
        the reference in ``dtype``."""
        raise NotImplementedError


class Reservoir:
    """A uniform sample of ``k`` of the calls, drawn from the seed as they
    complete (Algorithm R): only the sampled calls' outputs are held."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng(inputs.sub_seed(seed, "compare"))
        self.k = k
        self.kept: dict[int, object] = {}

    def offer(self, i: int, out) -> None:
        if len(self.kept) < self.k:
            self.kept[i] = out
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = out


def compare(checks: Checks, got: dict, want: dict) -> int:
    """``max_lsb`` of every output of the sampled calls; returns how many
    calls differ beyond the limit."""
    worst, failed = 0.0, 0
    for i, w in want.items():
        gap = max(lsb_gap(got[i].get(name, torch.empty(0)), img) for name, img in w.items())
        failed += int(gap > float(checks.limits["max_lsb"]))
        worst = max(worst, gap)
    checks.at_most("max_lsb", worst)
    return failed


def run(r, entry: type) -> dict:
    from imagetransformations_tpu_torch.ops.hopper import _lib

    tr, dev, seed = r.traffic, r.device, r.seed
    r.mark("imports and CUDA")
    x = inputs.images(seed, int(r.images), int(r.config["image_size"]), dev)
    drv = entry(r, x)
    r.mark("inputs")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # warm-up: the call's shapes, twice, on a generator of its own (the
    # first call builds and loads the kernels)
    g_warm = inputs.generator(seed, dev, "warm-up")
    for i in range(2):
        drv.port(drv.batch(i), g_warm)
    r.mark("warm-up (the first call builds the kernels)")

    stretch: dict = {}
    work = {"kind": "transform", "calls": int(tr["trace_calls"])}
    if r.trace:
        g_trace = inputs.generator(seed, dev, "trace")
        held = []
        with trace.stretch(stretch, dev):
            for i in range(int(tr["trace_calls"])):
                held.append((i, drv.drawn(drv.port(drv.batch(i), g_trace))))
        w = [drv.work(i, d) for i, d in held]
        work.update(bytes=sum(b for b, _ in w), flops=sum(f for _, f in w),
                    least_s=sum(least_time_s(b, f) for b, f in w))
        del held
        r.mark("traced stretch")

    g = inputs.generator(seed, dev, "calls")
    keep = Reservoir(seed, int(tr["compare_calls"]))
    before = dict(_lib.LAUNCHES)
    events = []
    start = torch.cuda.Event(enable_timing=True) if dev.type == "cuda" else None
    t_start = time.perf_counter()
    r.window_started(t_start)
    if start is not None:
        start.record()
    i = 0
    while True:
        out = drv.port(drv.batch(i), g)
        if start is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        keep.offer(i, drv.outputs(out))
        del out
        i += 1
        if time.perf_counter() - t_start >= r.seconds and i >= int(tr["compare_calls"]):
            break
    r.sync()
    t_end = time.perf_counter()
    launches = {k: _lib.LAUNCHES[k] - before.get(k, 0) for k in _lib.LAUNCHES}
    e2e = {"transform_gpix_per_s": i * drv.per_call * x.shape[1] * x.shape[2]
           / (t_end - t_start) / 1e9}
    if events:
        gaps = [start.elapsed_time(events[0])]
        gaps += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        e2e["transform_call_ms_p95"] = (statistics.quantiles(gaps, n=20, method="inclusive")[18]
                                        if len(gaps) > 1 else gaps[0])

    if r.trace:  # the host's cost to dispatch one call, after a synchronise each
        g_host = inputs.generator(seed, dev, "host")
        host_ms = []
        for j in range(int(tr["host_calls"])):
            r.sync()
            t = time.perf_counter()
            drv.port(drv.batch(j), g_host)
            host_ms.append((time.perf_counter() - t) * 1e3)
        r.sync()
        work["host_call_ms"] = statistics.median(host_ms)
    memory_peak = r.memory_peak()
    got = keep.kept
    r.free()

    picked = sorted(got)
    checks = Checks(r.limits)
    failed = compare(checks, got, drv.reference(picked))
    if dev.type == "cuda":  # the plain versions on the CPU launch no kernel
        for name in tr["kernels"]:
            checks.at_least(f"launches.{name}", launches.get(name, 0), 1)
    return {"attempted": i, "failed": failed, "checks": checks, "memory_peak": memory_peak,
            "end_to_end": e2e, "work": work, "stretch": stretch}


def control(r, entry: type, done: int) -> Checks:
    """The reference in bfloat16 in the port's place, on the calls a window
    of ``done`` calls would sample, held against the reference."""
    x = inputs.images(r.seed, int(r.images), int(r.config["image_size"]), r.device)
    drv = entry(r, x)
    keep = Reservoir(r.seed, int(r.traffic["compare_calls"]))
    for i in range(done):
        keep.offer(i, None)
    picked = sorted(keep.kept)
    checks = Checks(r.limits)
    compare(checks, drv.reference(picked, torch.bfloat16), drv.reference(picked))
    return checks
