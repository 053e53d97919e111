"""Profiling: a ``torch.profiler`` trace, per-op throughput, and the port's
spans and host-read counter (PyTorch).

Counterpart of ``imagetransformations_tpu/utils/profiling.py`` (the
reference has no tracing at all, SURVEY.md §5):

- ``trace(log_dir)``: a context manager that records the CPU and, where
  there is a card, the CUDA activity of its body with ``torch.profiler``
  and writes a Chrome trace (``trace.json``) into ``log_dir``, beside the
  spans recorded in the body (``spans.json``) and the device's idle time
  by the span open at each gap (``idle_by_span.json``).
- ``op_throughput``: the time of one call of an image op and the rates it
  gives. On the card CUDA events time ``k1`` and ``k2`` chained calls; on
  the CPU the wall clock does. The difference of the two runs over
  ``k2 - k1`` cancels the fixed cost of a run (the JAX package scans the op
  inside one compiled call for the same reason).
- ``span(name, **ids)`` and ``host_read(t, site)``: where the instrumented
  paths (a ``corruption_sweep`` cell, an ``apply_all_transformations``
  call) hold the stream, and where they bring a device tensor to the host.
  They record only while a ``torch.profiler`` profile is active, this
  module's ``trace`` or any other: otherwise ``span`` returns one shared
  no-op context and ``host_read`` is ``t.cpu()``, after one flag test.
  ``recorded()`` returns what was recorded since ``reset()``.
- ``idle_by_span``: device idle seconds by the innermost span open at each
  gap in the device's work.

The spans and reads are kept in one registry of this module, for the one
thread that runs the instrumented paths.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the body with ``torch.profiler`` (CPU, plus CUDA where
    available) and write into ``log_dir`` on leaving: ``trace.json``
    (Chrome trace format), ``spans.json`` (``recorded()``: the registry is
    reset on entry) and ``idle_by_span.json`` (``idle_by_span`` over the
    profile's own events). The profiler object is yielded for
    ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    rec = recorded()
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(rec, f)
    names = {s["name"] for s in rec["spans"]}
    device, spans, ends = [], [], []
    for e in prof.profiler.kineto_results.events():
        a = int(e.start_ns())
        b = a + int(e.duration_ns())
        is_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if e.is_user_annotation():
            if not is_device and e.name() in names:
                spans.append((e.name(), a, b))
            continue
        ends += [a, b]
        if is_device:
            device.append((a, b))
    window = (min(ends), max(ends)) if ends else None
    with open(os.path.join(log_dir, "idle_by_span.json"), "w") as f:
        json.dump(idle_by_span(device, spans, window), f)


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


# ------------------------------------------------------------------ spans


class _Registry:
    """The spans and host reads recorded since ``reset``."""

    def __init__(self):
        self.spans: list[_Span] = []  # in the order they opened
        self.open: list[_Span] = []  # the spans open now, innermost last
        self.reads: list[tuple[str, int | None, int]] = []  # (site, span, blocked ns)
        self.roots: dict[str, int] = {}  # root spans opened so far, by name


_REG = _Registry()


def reset() -> None:
    """Forget every span and read recorded so far."""
    global _REG
    _REG = _Registry()


class _NoSpan:
    """The context ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """One recorded span: its place in the tree, its host times
    (``time.perf_counter_ns``), the CUDA events recorded on the current
    stream at entry and exit, and its ``record_function`` range."""

    __slots__ = ("name", "ids", "reg", "index", "parent", "root", "seq", "start_ns", "end_ns",
                 "stream", "events", "range", "stream_ms")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids
        self.end_ns = self.events = self.stream_ms = None

    def __enter__(self):
        reg = self.reg = _REG
        self.index = len(reg.spans)
        up = reg.open[-1] if reg.open else None
        if up is None:
            self.parent, self.root = None, self.index
            self.seq = reg.roots.get(self.name, 0)
            reg.roots[self.name] = self.seq + 1
        else:  # a child shares its root's ids
            self.parent, self.root, self.seq, self.ids = up.index, up.root, up.seq, up.ids
        reg.spans.append(self)
        reg.open.append(self)
        self.start_ns = time.perf_counter_ns()
        self.range = torch.autograd.profiler.record_function(self.name)
        self.range.__enter__()
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()  # looked up once: its cost is a record's
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            self.events = (start,)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            self.events += (end,)
        self.range.__exit__(*exc)
        self.end_ns = time.perf_counter_ns()
        if self.reg.open and self.reg.open[-1] is self:
            self.reg.open.pop()
        return False

    def as_dict(self) -> dict:
        if self.stream_ms is None and self.events is not None and len(self.events) == 2:
            self.events[1].synchronize()
            self.stream_ms = self.events[0].elapsed_time(self.events[1])
        root = self.reg.spans[self.root].name
        return {"name": self.name, "index": self.index, "parent": self.parent,
                "root": self.root, "root_name": root, "seq": self.seq, "ids": self.ids,
                "host_start_ns": self.start_ns, "host_end_ns": self.end_ns,
                "stream_ms": self.stream_ms}


def span(name: str, **ids):
    """A context manager that records the block as span ``name`` while a
    ``torch.profiler`` profile is active: its parent (the innermost span
    open at entry), its root (the outermost) and the root's ``ids`` and
    ``seq`` (the root's index among the roots of its name since
    ``reset``), shared by every span of one cell or call; its host start
    and end; and the stream time between CUDA events recorded at entry and
    exit, read by ``recorded()`` (a span adds no synchronize). The block
    also runs inside a ``record_function`` range of the same name, which
    puts it in the profiler's own trace. While no profile is active this
    returns one shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, ids)


def host_read(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``: the port's one way to bring a device tensor to the host
    on the instrumented paths (``float(host_read(t, site))`` for a
    ``float(t)``). While a ``torch.profiler`` profile is active it also
    counts the read under ``site`` (on the CPU too, where the read is no
    copy) with the host nanoseconds it blocked, and the innermost span open
    then."""
    if not _autograd_profiler._is_profiler_enabled:
        return t.cpu()
    reg = _REG
    t0 = time.perf_counter_ns()
    out = t.cpu()
    reg.reads.append((site, reg.open[-1].index if reg.open else None,
                      time.perf_counter_ns() - t0))
    return out


def recorded() -> dict:
    """What was recorded since ``reset()``, as plain data:

    - ``spans``: one dict a span, in the order they opened: ``name``,
      ``index``, ``parent`` and ``root`` (indices, ``parent`` None for a
      root), ``root_name``, ``seq``, ``ids``, ``host_start_ns`` /
      ``host_end_ns`` (``time.perf_counter_ns``; the end None while open)
      and ``stream_ms`` (None without CUDA events or while open);
    - ``reads``: one dict a host read: ``site``, ``span`` (the innermost
      span open, or None), ``root_name`` (its root's name, or None) and
      ``blocked_ns``;
    - ``sites``: by site, ``count`` and ``blocked_ns``.

    Reading the stream times waits for the spans' last CUDA events."""
    reg = _REG
    spans = [s.as_dict() for s in reg.spans]
    reads, sites = [], {}
    for site, at, ns in reg.reads:
        reads.append({"site": site, "span": at, "blocked_ns": ns,
                      "root_name": None if at is None else spans[spans[at]["root"]]["name"]})
        c = sites.setdefault(site, {"count": 0, "blocked_ns": 0})
        c["count"] += 1
        c["blocked_ns"] += ns
    return {"spans": spans, "reads": reads, "sites": sites}


def _union(intervals) -> list[list[int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_by_span(device, spans, window=None) -> dict:
    """The device's idle time by the span the host was in.

    ``device``: (start_ns, end_ns) of the device's work (kernels, copies,
    sets); ``spans``: (name, start_ns, end_ns) of the spans' ranges on the
    same clock; ``window``: (start_ns, end_ns), by default the extent of
    both. The busy time is the union of the device intervals; each idle
    gap goes to the innermost span open at its middle (the latest-starting
    one that has not ended), else to ``"(no span)"``. Returns
    ``{"window_s", "busy_s", "idle_s", "by_span": [[name, seconds], ...]}``,
    most first; all zero without device intervals (a CPU run)."""
    if not device:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_s": 0.0, "by_span": []}
    if window is None:
        ends = [x for iv in device for x in iv] + [x for _, a, b in spans for x in (a, b)]
        window = (min(ends), max(ends))
    w0, w1 = window
    busy = _union([(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1])
    # by start, an enclosing span before the spans it holds
    ordered = sorted(((a, b, name) for name, a, b in spans), key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in ordered]
    reach = []  # the latest end among the spans up to each
    for s in ordered:
        reach.append(max(reach[-1], s[1]) if reach else s[1])
    by: dict[str, int] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = "(no span)"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if reach[j] < mid:
                break
            if ordered[j][1] >= mid:
                name = ordered[j][2]
                break
        by[name] = by.get(name, 0) + (b - a)
    busy_ns = sum(b - a for a, b in busy)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "idle_s": (w1 - w0 - busy_ns) / 1e9,
            "by_span": [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]}
