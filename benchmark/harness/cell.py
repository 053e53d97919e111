"""One run of one cell: find its files by name, drive its traffic kind
(``harness/<kind>_kind.py``), read its metrics, and make the result line.

``run_cell`` returns (result, check lines); ``run.py`` prints them. The
result's keys are the contract's: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, each the value its kind
reports under the metric's family, or with ``trace`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``checks`` (each compared number and
its limit) comes last."""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from harness import spec as bspec

#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "imagetransformations_tpu"}


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


class Forbidden(RuntimeError):
    """The process loaded JAX or the JAX package."""


@dataclasses.dataclass
class Run:
    """What a traffic kind gets: the cell's files, the run's arguments, and
    the device helpers."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float  # host clock at the start of the process
    images: int = 0
    chips: int = 1
    setup_s: float = 0.0
    phases: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Record that set-up ``phase`` ended now (seconds since the process
        started; printed to standard error with the result)."""
        self.sync()
        self.phases.append((phase, time.perf_counter() - self.t_process))

    def window_started(self, t: float) -> None:
        self.setup_s = t - self.t_process

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        self.sync()
        return int(torch.cuda.max_memory_allocated()) if self.device.type == "cuda" else 0

    def free(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def forbidden_modules() -> set[str]:
    return {m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN


def make_run(cell: str, seed: int, seconds: float, trace: bool, t_process: float,
             device: str = "cuda", images: int | None = None) -> Run:
    """The cell's ``Run``. ``device="cuda"`` looks for the cell's chips and
    raises ``NoDevice`` without them; the tests pass "cpu" and a small
    ``images`` to drive the rest of a run on the plain versions."""
    spec = bspec.load()
    w = bspec.workload(spec, cell)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
            raise NoDevice(f"{cell} needs {w['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cfg = bspec.config(spec, w["config"])
    return Run(cell=cell, config=cfg, traffic=bspec.traffic(w["traffic"]),
               limits=bspec.limits(cell), seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=dev, t_process=t_process,
               images=int(images if images is not None else cfg["images"]),
               chips=int(w["chips"]))


def run_cell(r: Run) -> tuple[dict, list[str]]:
    spec = bspec.load()
    out = bspec.kind(r.traffic["kind"]).run(r)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"the run loaded {sorted(found)}")
    device = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
              "kind": torch.cuda.get_device_name(r.device) if r.device.type == "cuda" else "cpu",
              "count": r.chips, "memory_peak_bytes": out["memory_peak"]}
    metrics = {}
    breakdown = None
    if not r.trace:
        values = dict(out["end_to_end"], setup_s=r.setup_s)
        for m in bspec.end_to_end(spec, r.cell):
            if bspec.family(m["name"]) in values:
                metrics[m["name"]] = {"value": values[bspec.family(m["name"])],
                                      "unit": m["unit"]}
    else:
        st = out["stretch"]
        device.update(busy_s=st.get("busy_s", 0.0), window_s=st.get("window_s", 0.0))
        ctx = {"trace": st, "work": out["work"], "device": device}
        for m in bspec.per_layer(spec, r.cell):
            v = bspec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if st:
            breakdown = {"device_ops": st["device_ops"], "idle_gaps": st["idle_gaps"]}
    checks = out["checks"]
    lines = [f"setup {name} ends at {t:.3f} s" for name, t in r.phases]
    lines.append(f"window starts at {r.setup_s:.3f} s")
    result = {"correct": checks.correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks.as_json()
    return result, lines + checks.lines()
