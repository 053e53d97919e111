"""The readers of the port's spans and host-read counter
(``metrics/generator_share_pct.py``, ``odin_share_pct``,
``stats_share_pct``, ``plain_types_share_pct``, ``host_reads_per_call``;
``harness/spans.py``) on a hand-made registry, and None where nothing was
recorded: a CPU run, another cell's spans, or a port without
``profiling.recorded``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from harness import spec
from imagetransformations_tpu_torch.utils import profiling

S = spec.load()
NEW = ["generator_share_pct", "odin_share_pct", "stats_share_pct", "plain_types_share_pct",
       "host_reads_per_call"]


def _span(i, name, parent, root, root_name, ms):
    return {"name": name, "index": i, "parent": parent, "root": root, "root_name": root_name,
            "seq": 0, "ids": {}, "host_start_ns": i, "host_end_ns": i + 1, "stream_ms": ms}


def _registry():
    """Two sweep cells (100 and 50 ms of stream) and one apply_all call
    (10 ms), with three reads in the cells and one in the call."""
    spans = []

    def add(name, parent, root, root_name, ms):
        spans.append(_span(len(spans), name, parent, root, root_name, ms))
        return len(spans) - 1

    for cell_ms, parts in ((100.0, (4.0, 30.0, 60.0, 2.0)), (50.0, (1.0, 15.0, 30.0, 1.0))):
        c = add("sweep.cell", None, len(spans), "sweep.cell", cell_ms)
        for name, ms in zip(("sweep.generate", "sweep.forward", "sweep.odin", "sweep.stats"),
                            parts):
            add(name, c, c, "sweep.cell", ms)
    c = add("apply_all.call", None, len(spans), "apply_all.call", 10.0)
    for t, ms in (("scale", 2.0), ("rotation", 2.0), ("lighten_darken", 0.5),
                  ("gaussian_noise", 1.0), ("translation", 1.0), ("contrast", 0.5),
                  ("blur", 1.5), ("shear", 1.0)):
        add(f"apply_all.{t}", c, c, "apply_all.call", ms)
    reads = [{"site": s, "span": at, "root_name": root, "blocked_ns": 10}
             for s, at, root in (("corruptions.live_taps", 1, "sweep.cell"),
                                 ("sweep.aurocs", 4, "sweep.cell"),
                                 ("sweep.accuracy", 4, "sweep.cell"),
                                 ("rotation.max_angle", 12, "apply_all.call"),
                                 ("elsewhere", None, None))]
    return {"spans": spans, "reads": reads, "sites": {}}


def _read(family, kind="sweep"):
    return spec.metric_reader(f"{family}.x")({"trace": {}, "work": {"kind": kind},
                                              "device": {}})


def test_each_new_metric_has_its_reader_and_names_its_cells():
    names = {m["name"]: m for m in S["per_layer"]}
    for family, cells in (("generator_share_pct", ("c10c", "inc")), ("odin_share_pct", ("c10c",)),
                          ("stats_share_pct", ("c10c", "inc")),
                          ("plain_types_share_pct", ("augment",)),
                          ("host_reads_per_call", ("c10c", "inc", "augment"))):
        for mix in cells:
            m = names[f"{family}.{mix}"]
            assert len(m["workloads"]) == 1 and m["workloads"][0].endswith("." + mix)
            assert m["source"] == ("program_counter" if family == "host_reads_per_call"
                                   else "program_span")


def test_readers_on_a_hand_made_registry(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", _registry)
    assert _read("generator_share_pct") == pytest.approx(100.0 * 5.0 / 150.0)
    assert _read("odin_share_pct") == pytest.approx(100.0 * 90.0 / 150.0)
    assert _read("stats_share_pct") == pytest.approx(100.0 * 3.0 / 150.0)
    assert _read("plain_types_share_pct") == pytest.approx(100.0 * 3.0 / 10.0)
    assert _read("host_reads_per_call", "sweep") == pytest.approx(3 / 2)
    assert _read("host_reads_per_call", "transform") == pytest.approx(1.0)


def test_readers_find_nothing_in_another_cells_spans(monkeypatch):
    reg = _registry()
    sweep_only = dict(reg, spans=reg["spans"][:10])
    monkeypatch.setattr(profiling, "recorded", lambda: sweep_only)
    assert _read("plain_types_share_pct") is None
    assert _read("host_reads_per_call", "transform") is None
    assert _read("host_reads_per_call", "chain") is None


@pytest.mark.parametrize("family", NEW)
def test_none_without_the_ports_recorded(monkeypatch, family):
    monkeypatch.delattr(profiling, "recorded")
    assert _read(family, "transform" if family == "plain_types_share_pct" else "sweep") is None


@pytest.mark.parametrize("family", NEW)
def test_none_where_nothing_was_recorded(family):
    profiling.reset()
    assert _read(family) is None and _read(family, "transform") is None


def test_cpu_spans_have_no_stream_time_but_count_reads():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("sweep.cell"):
            with profiling.span("sweep.generate"):
                profiling.host_read(torch.ones(1), "site")
            with profiling.span("sweep.stats"):
                pass
    assert _read("generator_share_pct") is None  # no CUDA events on the CPU
    assert _read("host_reads_per_call") == 1.0
    profiling.reset()
