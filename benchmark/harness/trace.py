"""A traced stretch: torch.profiler over a short steady run of the cell's
work, reduced to what the per-layer metrics read.

- ``window_s``: the stretch, from its first recorded event (the host's
  first CUDA call) to the end of its last (it ends with a synchronize);
- ``busy_s``: the union of the device intervals (kernels, copies, sets) in
  it, so operations that overlap count once;
- ``device_ops``: device seconds by operation name, most first;
- ``idle_gaps``: the seconds in which the device was idle, by the CUDA
  call the host was in then (the latest begun that had not ended; "(no
  CUDA call)": the host was in Python or PyTorch between calls), most
  first.

Only CUDA activity is recorded (kernels, copies and the host's CUDA
runtime calls): recording every PyTorch operator on the host as well
doubled a ResNet-56 sweep cell's time (its ~36 000 launches), which the
idle share would have read as the card's. torch.profiler loses device time
after tens of thousands of launches in one process, so the stretch runs
before the measured window."""

from __future__ import annotations

import bisect
import contextlib

import torch

def _events(prof):
    """(name, is_device, start_ns, end_ns) of every recorded event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), dev, int(e.start_ns()), int(e.start_ns() + e.duration_ns())))
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events) -> dict:
    """The stretch's ``window_s``, ``busy_s``, ``device_ops`` and
    ``idle_gaps`` (see the module note) from ``_events``' tuples."""
    dev_iv = [(a, b) for _, dev, a, b in events if dev]
    if not dev_iv:
        return {"window_s": 0.0, "busy_s": 0.0, "device_ops": [], "idle_gaps": []}
    w0 = min(a for _, _, a, _ in events)
    w1 = max(b for _, _, _, b in events)
    busy = _union([(max(a, w0), min(b, w1)) for a, b in dev_iv if b > w0 and a < w1])
    busy_ns = sum(b - a for a, b in busy)
    by_op: dict[str, int] = {}
    for name, dev, a, b in events:
        if dev:
            by_op[name] = by_op.get(name, 0) + (b - a)
    host = sorted((a, b, name) for name, dev, a, b in events if not dev)
    starts = [h[0] for h in host]
    gaps: dict[str, int] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = "(no CUDA call)"
        k = bisect.bisect_right(starts, mid)
        for j in range(k - 1, max(-1, k - 400), -1):  # the latest-starting op still running
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] = gaps.get(name, 0) + (b - a)

    def ranked(d):
        return [[k[:120], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}


@contextlib.contextmanager
def stretch(result: dict, device):
    """Profile the block; on leaving (after a synchronize), ``result`` holds
    ``summarize``'s dict. On the CPU the block runs untraced and ``result``
    stays empty: a CPU run has no device trace."""
    if torch.device(device).type != "cuda":
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    result.update(summarize(_events(prof)))
