#!/usr/bin/env python3
"""Check the port's spans and host-read counter (``utils.profiling``) on one
NVIDIA GPU.

    python3 tools/check_spans.py [--out DIR]

Runs the benchmark's traced work (``benchmark/``: the c10c sweep's cells 0,
5 and 10, ResNet-56 with ODIN and Mahalanobis over 10 000 32x32 images;
the inc sweep's cells 0 and 7, ResNet-50 over 4 096 224x224 images, logit
metrics only; ``apply_all_transformations`` over 10 000 32x32 images) on
random weights and images, each corruption drawing from its cell's
generator, and prints one JSON line a check:

1. ``flag``: ``torch.autograd.profiler._is_profiler_enabled``, the flag
   the spans test, before, inside and after a
   ``profile(activities=[ProfilerActivity.CUDA])`` (the benchmark's form),
   and whether that profile holds the spans' ``record_function`` ranges.
2. ``syncs.<mix>``: with ``torch.cuda.set_sync_debug_mode("warn")`` over
   the traced cells of each mix and 3 ``apply_all`` calls inside a CUDA
   profile, the synchronizing warnings by where they came from (a
   ``host_read`` site, or the port's file and line) against the
   ``host_read`` counts by site; and each cell's children's stream time
   over its own (``cover``).
3. ``cost``: the host time of the traced stretch (CUDA profile) with the
   spans recording against the same stretch with ``span`` and
   ``host_read`` stubbed (no recording), in turns; 20 ``apply_all`` calls
   with no profile, the spans' flag test against the stub; and the
   microseconds a span adds to a launch, by part.
4. ``clock``: under ``profiling.trace`` (CPU and CUDA) over c10c's cell 5
   and 20 ``apply_all`` calls: each span's host start against its
   ``record_function`` event's start in the profile, and
   ``idle_by_span.json``'s split of the device's idle time.

Writes the lines to ``DIR/check_spans.json`` as well (default
``chiprun_out``). Needs a CUDA device; exits 1 without one. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C10C = ["gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur", "glass_blur",
        "motion_blur", "zoom_blur", "snow", "frost", "fog", "brightness", "contrast",
        "elastic_transform", "pixelate", "jpeg_compression"]


def sweep_cell(i: int) -> tuple[str, int]:
    """The benchmark's cell ``i``: (corruption, severity)."""
    k = len(C10C)
    return C10C[i % k], ((i % k) + i // k) % 5 + 1


class Sweep:
    """One sweep mix: its network, images, labels and cells."""

    def __init__(self, torch, dev, network, space, n, size, uq, cells):
        from imagetransformations_tpu_torch.uq import mahalanobis

        g = torch.Generator(device=dev).manual_seed(7)
        self.x = torch.randint(0, 256, (n, size, size, 3), generator=g, device=dev,
                               dtype=torch.uint8)
        self.net = network.eval()
        self.y = torch.randint(0, self.net.fc.out_features, (n,), generator=g, device=dev)
        self.space, self.cells, self.dev, self.extras = space, cells, dev, None
        if uq:
            with torch.no_grad():
                feats = torch.cat([self.net.features(space(self.x[a: a + 256]))
                                   for a in range(0, n, 256)])
            st = mahalanobis.fit(feats)
            self.extras = {"feats_logits_fn": self.net.features_and_logits,
                           "maha_mean": st.mean, "maha_precision": st.precision,
                           "odin_temperature": 1000.0, "odin_eps": 0.0014}

    def cell(self, i: int, m: int | None = None):
        from imagetransformations_tpu_torch.evalx import harness

        name, sev = sweep_cell(i)
        return harness.corruption_sweep(
            self.net, self.space, self.x[:m], self.y[:m], seed=11, corruption_names=(name,),
            severities=(sev,), batch_size=256,
            metric_names=("shannon_entropy", "msp", "margin", "energy"),
            uq_extras=self.extras, device=self.dev)

    def run(self):
        for i in self.cells:
            self.cell(i)


def where() -> str:
    """The ``host_read`` site the current synchronizing call came from, else
    the innermost frame of the port (file:line)."""
    f = sys._getframe(1)
    port = caller = None
    while f is not None:
        code = f.f_code
        if code.co_name == "host_read" and code.co_filename.endswith("profiling.py"):
            return "host_read:" + f.f_locals["site"]
        if port is None and "imagetransformations_tpu_torch" in code.co_filename:
            port = f"{os.path.relpath(code.co_filename, ROOT)}:{f.f_lineno}"
        if caller is None and code.co_name not in ("show", "where", "_showwarnmsg"):
            caller = f"{os.path.basename(code.co_filename)}:{f.f_lineno}"
        f = f.f_back
    return port or f"(outside the port: thread {threading.current_thread().name}, {caller})"


def syncs(torch, fn) -> tuple[dict, dict]:
    """Run ``fn`` in a CUDA profile under the sync debug mode "warn": (the
    synchronizing warnings by ``where``, ``profiling.recorded()``)."""
    from torch.profiler import ProfilerActivity, profile

    from imagetransformations_tpu_torch.utils import profiling

    hits: collections.Counter = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            hits[where()] += 1

    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return dict(hits), profiling.recorded()


def cover(rec: dict, root: str) -> list[float]:
    """Each root span's children's stream time over its own."""
    spans = rec["spans"]
    out = []
    for r in spans:
        if r["name"] == root and r["parent"] is None:
            kids = sum(s["stream_ms"] for s in spans if s["parent"] == r["index"])
            out.append(kids / r["stream_ms"])
    return out


def compare(hits: dict, rec: dict) -> dict:
    """The warnings against the ``host_read`` counts, site by site."""
    counted = {f"host_read:{k}": v["count"] for k, v in rec["sites"].items()}
    sites = sorted(set(counted) | set(hits))
    return {"by_site": {s: {"warnings": hits.get(s, 0), "counted": counted.get(s, 0)}
                        for s in sites},
            "equal": all(hits.get(s, 0) == counted.get(s, 0) for s in counted),
            "not_counted": {s: n for s, n in hits.items() if s not in counted}}


def stubbed(profiling):
    """A context in which ``span`` and ``host_read`` never record."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        span, read = profiling.span, profiling.host_read
        profiling.span = lambda name, **ids: profiling._NO_SPAN
        profiling.host_read = lambda t, site: t.cpu()
        try:
            yield
        finally:
            profiling.span, profiling.host_read = span, read
    return ctx()


def turns(torch, profiling, fn, profiled: bool, pairs: int) -> dict:
    """Host seconds of ``fn`` with the spans (``spans``) and with them
    stubbed (``stub``), ``pairs`` times each in turns (spans first, then
    stub first, ...), after one run of each that is not kept; and the
    median of the first over the median of the second, less 1, in %."""
    t = {"spans": [], "stub": []}
    order = ["spans", "stub"] + [w for k in range(pairs) for w in
                                 (("spans", "stub") if k % 2 else ("stub", "spans"))]
    for k, which in enumerate(order):
        if which == "stub":
            with stubbed(profiling):
                s = wall(torch, fn, profiled)
        else:
            s = wall(torch, fn, profiled)
        if k >= 2:
            t[which].append(s)
    t["cost_pct"] = 100.0 * (statistics.median(t["spans"]) / statistics.median(t["stub"]) - 1)
    return t


def span_us(torch, profiling, dev, n: int = 5000) -> dict:
    """Microseconds a span adds to a one-element kernel launch: the whole
    span, its two CUDA events alone and its ``record_function`` range
    alone, inside a CUDA profile, and the whole span with no profile (the
    flag test)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device=dev)

    def bare():
        x.add_(1)

    def whole():
        with profiling.span("probe"):
            x.add_(1)

    def events():
        stream = torch.cuda.current_stream()
        a = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        x.add_(1)
        b = torch.cuda.Event(enable_timing=True)
        b.record(stream)

    def annotated():
        with torch.autograd.profiler.record_function("probe"):
            x.add_(1)

    def per_us(fn):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t) / n * 1e6)
        return best

    out = {"off.bare_us": per_us(bare), "off.span_us": per_us(whole)}
    with profile(activities=[ProfilerActivity.CUDA]):
        profiling.reset()
        for name, fn in (("bare", bare), ("span", whole), ("events", events),
                         ("record_function", annotated)):
            out[f"cuda_profile.{name}_us"] = per_us(fn)
    profiling.reset()
    return out


def wall(torch, fn, profiled: bool) -> float:
    """Host seconds of ``fn`` (in a CUDA profile where ``profiled``),
    between synchronizes."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) if profiled else contextlib.nullcontext():
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("check_spans: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from imagetransformations_tpu_torch.models import imagenet, resnet
    from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations
    from imagetransformations_tpu_torch.utils import profiling

    lines = []

    def emit(d):
        lines.append(d)
        print(json.dumps(d), flush=True)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"check": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvidia_smi": smi})

    # 1. the flag under the benchmark's form of profile
    flag = [bool(torch.autograd.profiler._is_profiler_enabled)]
    torch.zeros(1, device=dev)  # CUDA starts before the probe: a span times only after
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flag.append(bool(torch.autograd.profiler._is_profiler_enabled))
        with profiling.span("probe"):
            torch.ones(1024, device=dev).sum()
        torch.cuda.synchronize()
    flag.append(bool(torch.autograd.profiler._is_profiler_enabled))
    ann = collections.Counter(
        (e.name(), str(e.device_type())) for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation())
    rec = profiling.recorded()
    emit({"check": "flag", "before_inside_after": flag,
          "probe_stream_ms": rec["spans"][0]["stream_ms"] if rec["spans"] else None,
          "annotations_in_cuda_profile": {f"{k[0]} ({k[1]})": v for k, v in ann.items()}})

    # the three mixes, warmed up
    x_aug = torch.randint(0, 256, (10000, 32, 32, 3), device=dev, dtype=torch.uint8,
                          generator=torch.Generator(device=dev).manual_seed(3))
    g_aug = torch.Generator(device=dev).manual_seed(5)

    def augment(calls):
        def fn():
            for _ in range(calls):
                apply_all_transformations(x_aug, g_aug, device=dev)
        return fn

    mixes = {
        "c10c": lambda: Sweep(torch, dev, resnet.resnet56(10, device=dev),
                              resnet.cifar_model_space, 10000, 32, True, [0, 5, 10]),
        "inc": lambda: Sweep(torch, dev, imagenet.ResNet50(1000, device=dev),
                             imagenet.imagenet_model_space, 4096, 224, False, [0, 7]),
    }
    augment(2)()
    c10c = None
    for mix, make in mixes.items():
        sw = make()
        for i in sw.cells:
            sw.cell(i, 16)
        sw.cell(sw.cells[0], 256)

        # 2. synchronizing calls against the counted reads; coverage
        hits, rec = syncs(torch, sw.run)
        emit({"check": f"syncs.{mix}", "cells": [sweep_cell(i) for i in sw.cells],
              **compare(hits, rec), "cover": cover(rec, "sweep.cell"),
              "cell_stream_ms": [s["stream_ms"] for s in rec["spans"]
                                 if s["name"] == "sweep.cell"]})

        # 3. the traced stretch with and without recording, in turns
        emit({"check": f"cost.{mix}", "traced": turns(torch, profiling, sw.run, True, 2)})
        if mix == "c10c":
            c10c = sw
        del sw
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    hits, rec = syncs(torch, augment(3))
    emit({"check": "syncs.augment", **compare(hits, rec), "cover": cover(rec, "apply_all.call"),
          "type_stream_ms": {s["name"]: s["stream_ms"] for s in rec["spans"]
                             if s["root_name"] == "apply_all.call" and s["parent"] is not None}})
    emit({"check": "cost.augment",
          "traced": turns(torch, profiling, augment(20), True, 6),
          "untraced": turns(torch, profiling, augment(20), False, 6)})
    emit({"check": "cost.span", **span_us(torch, profiling, dev)})

    # 4. the spans' host clock against the profile's, and the idle split
    for mix, fn in (("c10c", lambda: c10c.cell(5)), ("augment", augment(20))):
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d) as prof:
                fn()
            rec = profiling.recorded()
            ev = collections.defaultdict(list)  # each span name's range starts, in order
            for e in prof.profiler.kineto_results.events():
                if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
                    ev[e.name()].append(int(e.start_ns()))
            for v in ev.values():
                v.sort()
            offs, seen = [], collections.Counter()
            for s in rec["spans"]:
                k = seen[s["name"]]
                seen[s["name"]] += 1
                if k < len(ev[s["name"]]):
                    offs.append(ev[s["name"]][k] - s["host_start_ns"])
            med = statistics.median(offs) if offs else None
            with open(os.path.join(d, "idle_by_span.json")) as f:
                idle = json.load(f)
            emit({"check": f"clock.{mix}", "spans": len(rec["spans"]), "matched": len(offs),
                  "profile_minus_host_ns": {"median": med,
                                            "min_dev": min(offs) - med if offs else None,
                                            "max_dev": max(offs) - med if offs else None},
                  "idle_by_span": idle})

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "check_spans.json"), "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
