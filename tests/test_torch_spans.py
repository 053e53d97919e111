"""The port's spans and host-read counter (``utils.profiling``), CPU.

- ``span`` nests, records its parent, its root and the root's ids, and
  records nothing outside a profiler;
- outside a profiler the instrumented paths (a 2-cell ``corruption_sweep``
  with ODIN and Mahalanobis, an ``apply_all_transformations`` call) create
  no CUDA event, open no ``record_function`` range and write nothing;
- inside ``profiling.trace`` and inside a bare ``torch.profiler.profile``
  the same runs record each ``sweep.cell`` with its four kinds of child,
  each ``apply_all.call`` with its 8 type spans, and the expected
  ``host_read`` sites;
- ``idle_by_span`` on hand-made intervals.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.evalx import harness as ph
from imagetransformations_tpu_torch.models.resnet import cifar_model_space
from imagetransformations_tpu_torch.pipeline.batch import TYPES, apply_all_transformations
from imagetransformations_tpu_torch.uq import mahalanobis as pmh
from imagetransformations_tpu_torch.utils import profiling

#: the sweep's two cells: motion blur reads its per-image taps back
CELLS = ("motion_blur", "brightness")
N, BATCH = 12, 8  # two batches a cell, the last one padded


@pytest.fixture(scope="module")
def sweep_setup():
    torch.manual_seed(0)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (N, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, N).astype(np.int64)
    net = pm.CifarResNet((1, 1, 1), device="cpu")
    with torch.no_grad():
        st = pmh.fit(net.features(cifar_model_space(torch.from_numpy(imgs))))
    extras = {"feats_logits_fn": net.features_and_logits, "maha_mean": st.mean,
              "maha_precision": st.precision}
    return net, imgs, labels, extras


def _run(sweep_setup):
    """A 2-cell sweep with ODIN and Mahalanobis, then one apply_all call;
    returns (the sweep's result, the call's result)."""
    net, imgs, labels, extras = sweep_setup
    res = ph.corruption_sweep(net, cifar_model_space, imgs, labels, seed=1,
                              corruption_names=CELLS, severities=(3,), batch_size=BATCH,
                              metric_names=("msp", "energy"), uq_extras=extras, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 16, 16, 3),
                                                           dtype=np.uint8))
    return res, apply_all_transformations(x, 7, device="cpu")


def _empty():
    return {"spans": [], "reads": [], "sites": {}}


def test_span_nests_and_shares_its_root_ids():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("cell", corruption="fog", severity=2):
            with profiling.span("inner"):
                with profiling.span("innermost"):
                    pass
            with profiling.span("sibling"):
                profiling.host_read(torch.ones(2), "site.a")
        with profiling.span("cell", corruption="snow", severity=1):
            pass
        profiling.host_read(torch.zeros(1), "site.b")
    rec = profiling.recorded()
    got = [(s["name"], s["parent"], s["root"], s["seq"]) for s in rec["spans"]]
    assert got == [("cell", None, 0, 0), ("inner", 0, 0, 0), ("innermost", 1, 0, 0),
                   ("sibling", 0, 0, 0), ("cell", None, 4, 1)]
    assert [s["ids"] for s in rec["spans"]] == [{"corruption": "fog", "severity": 2}] * 4 + [
        {"corruption": "snow", "severity": 1}]
    assert all(s["root_name"] == "cell" for s in rec["spans"])
    for s in rec["spans"]:
        assert s["host_start_ns"] <= s["host_end_ns"]
        assert s["stream_ms"] is None  # no CUDA events on the CPU
    outer, inner = rec["spans"][0], rec["spans"][2]
    assert outer["host_start_ns"] <= inner["host_start_ns"] <= inner["host_end_ns"] \
        <= outer["host_end_ns"]
    assert [(r["site"], r["span"], r["root_name"]) for r in rec["reads"]] == [
        ("site.a", 3, "cell"), ("site.b", None, None)]
    assert set(rec["sites"]) == {"site.a", "site.b"}
    assert all(v["count"] == 1 and v["blocked_ns"] >= 0 for v in rec["sites"].values())
    json.dumps(rec)  # plain data
    profiling.reset()
    assert profiling.recorded() == _empty()


def test_nothing_records_outside_a_profiler():
    profiling.reset()
    a = profiling.span("cell", corruption="fog")
    assert a is profiling.span("other")  # one shared no-op context
    with a as got:
        assert got is None
        t = torch.arange(3.0)
        assert torch.equal(profiling.host_read(t, "site"), t)
    assert profiling.recorded() == _empty()


def test_off_path_makes_no_event_no_range_and_no_record(sweep_setup, monkeypatch):
    """Outside a profiler the instrumented sweep and apply_all call neither
    create a CUDA event nor open a ``record_function`` range (both patched
    to raise), nor add to the registry; their results equal a run inside a
    profiler."""
    def refuse(*a, **k):
        raise AssertionError("called while nothing records")

    want = None
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        want = _run(sweep_setup)
    profiling.reset()
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    res, out = _run(sweep_setup)
    assert profiling.recorded() == _empty()
    assert res == want[0]
    for t in TYPES:
        assert torch.equal(out[t][0], want[1][t][0]) and torch.equal(out[t][1], want[1][t][1])


def _check_recorded(rec):
    spans = rec["spans"]
    cells = [s for s in spans if s["name"] == "sweep.cell"]
    assert [(c["parent"], c["ids"], c["seq"]) for c in cells] == [
        (None, {"corruption": name, "severity": 3}, k) for k, name in enumerate(CELLS)]
    batches = -(-N // BATCH)
    for c in cells:
        kids = [s["name"] for s in spans if s["parent"] == c["index"]]
        assert kids == ["sweep.generate"] + ["sweep.forward", "sweep.odin"] * batches + [
            "sweep.stats"]
        assert all(s["root"] == c["index"] and s["ids"] == c["ids"] for s in spans
                   if s["root"] == c["index"])
    calls = [s for s in spans if s["name"] == "apply_all.call"]
    assert len(calls) == 1 and calls[0]["parent"] is None
    kids = [s["name"] for s in spans if s["parent"] == calls[0]["index"]]
    assert kids == [f"apply_all.{t}" for t in TYPES]
    sites = [(r["site"], r["root_name"]) for r in rec["reads"]]
    assert sites == [("corruptions.live_taps", "sweep.cell"), ("sweep.aurocs", "sweep.cell"),
                     ("sweep.accuracy", "sweep.cell"), ("sweep.aurocs", "sweep.cell"),
                     ("sweep.accuracy", "sweep.cell"), ("rotation.max_angle", "apply_all.call")]
    live = [s for s in spans if s["index"] == rec["reads"][0]["span"]]
    assert live[0]["name"] == "sweep.generate" and live[0]["ids"]["corruption"] == "motion_blur"


def test_trace_records_spans_and_writes_them(sweep_setup, tmp_path):
    profiling.reset()
    with profiling.span("left over"):  # recorded before: trace resets on entry
        pass
    with profiling.trace(str(tmp_path)):
        _run(sweep_setup)
    rec = profiling.recorded()
    _check_recorded(rec)
    assert json.loads((tmp_path / "spans.json").read_text()) == rec
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"sweep.cell", "sweep.odin", "apply_all.call", "apply_all.blur"} <= names
    idle = json.loads((tmp_path / "idle_by_span.json").read_text())
    assert set(idle) == {"window_s", "busy_s", "idle_s", "by_span"}
    assert idle["busy_s"] == 0.0 and idle["by_span"] == []  # no device on the CPU


def test_bare_profiler_records_the_same(sweep_setup):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _run(sweep_setup)
    _check_recorded(profiling.recorded())
    profiling.reset()


def test_idle_by_span_puts_each_gap_on_the_innermost_open_span():
    device = [(0, 10), (20, 30), (25, 35), (50, 60)]
    spans = [("cell", 5, 70), ("odin", 12, 22), ("stats", 40, 45), ("stats.inner", 40, 44)]
    got = profiling.idle_by_span(device, spans, (0, 100))
    assert got["window_s"] == 100e-9
    assert got["busy_s"] == pytest.approx(35e-9)  # overlapping intervals count once
    assert got["idle_s"] == pytest.approx(65e-9)
    by = dict(got["by_span"])
    # gaps: 10-20 (middle 15: odin), 35-50 (middle 42: the innermost of
    # two spans that start together), 60-100 (middle 80: outside every span)
    assert by == pytest.approx({"odin": 10e-9, "stats.inner": 15e-9, "(no span)": 40e-9})
    assert got["by_span"][0][0] == "(no span)"


def test_idle_by_span_window_and_empty_cases():
    zero = {"window_s": 0.0, "busy_s": 0.0, "idle_s": 0.0, "by_span": []}
    assert profiling.idle_by_span([], []) == zero
    assert profiling.idle_by_span([], [("cell", 0, 10)], (0, 20)) == zero  # no device trace
    # the default window is the extent of both; a gap in a span that holds
    # none of the device's work still goes to it
    got = profiling.idle_by_span([(10, 20)], [("generate", 0, 30)])
    assert got["window_s"] == 30e-9 and dict(got["by_span"]) == pytest.approx(
        {"generate": 20e-9})
    # a span that ended before the gap's middle does not hold it
    got = profiling.idle_by_span([(0, 10), (40, 50)], [("a", 0, 5), ("b", 12, 14)])
    assert dict(got["by_span"]) == pytest.approx({"(no span)": 30e-9})
