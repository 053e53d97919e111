"""``BENCHMARK.json`` and the data files it names, found by name.

- a configuration: the ``file`` of its ``configs`` entry (sizes, the port's
  model and the reference's), under ``benchmark/configs/``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``: its ``kind`` names
  the harness's code for it, ``benchmark/harness/<kind>_kind.py``, and the
  rest are that kind's parameters;
- a cell's limits: ``benchmark/limits/<cell>.json`` (each compared
  number's limit, set from the readings that PERF.md gives);
- a per-layer metric: the reader of its family,
  ``benchmark/metrics/<family>.py``, whose ``read(ctx)`` returns the value
  or None.

A metric's family is its name up to the first ".": the quantity that a
kind reports (``eval_images_per_s``, ``device_idle_pct``), which the
metrics of different cells share (``eval_images_per_s.c10c``,
``eval_images_per_s.inc``), each with its own bound.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    return _by_name(spec["workloads"], name, "workload")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / _by_name(spec["configs"], name, "configuration")["file"]) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(BENCH / "limits" / f"{cell}.json")


def end_to_end(spec: dict, cell: str) -> list[dict]:
    """The cell's end-to-end metrics: those without ``workloads`` and those
    that list it."""
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(spec: dict, cell: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    ``workloads`` whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def family(metric: str) -> str:
    return metric.partition(".")[0]


def kind(name: str):
    """The module of traffic kind ``name``: ``harness/<name>_kind.py``,
    with ``run(r)`` (one run of a cell) and ``control(r, done)``."""
    if not NAME.match(name) or "." in name:
        raise KeyError(f"no traffic kind named {name!r}")
    return importlib.import_module(f"harness.{name}_kind")


def metric_reader(name: str):
    """``read(ctx)`` of ``benchmark/metrics/<family>.py``, the reader of
    the metric's family."""
    path = BENCH / "metrics" / f"{family(name)}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
