"""The port's ``sweep`` and ``report`` commands, and
``workflows.uncertainty_report`` (CPU).

The demo recipe (``utils.demo``) is cut to 64 training and 32 test images of
synthetic data (no CIFAR pickles under the tmp ``--data-root``). The sweep's
table equals ``corruption_sweep`` on the same demo model, printed with the
JAX table's columns and written as ``sweep.json``; ``report`` prints each
metric's AUROC and threshold from ``uncertainty_report``. Without matplotlib
both say that no PNG was written.
"""

import json
import os

import numpy as np
import pytest

from imagetransformations_tpu_torch import workflows
from imagetransformations_tpu_torch.__main__ import main
from imagetransformations_tpu_torch.evalx import harness, report
from imagetransformations_tpu_torch.utils import demo

from test_torch_models import _torch_threads  # noqa: F401


@pytest.fixture
def small_demo(monkeypatch):
    get_data = demo.get_data
    monkeypatch.setattr(demo, "get_data", lambda root, verbose=False: get_data(
        root, n_train=64, n_test=32, verbose=verbose))


def test_sweep_command(tmp_path, small_demo, capsys):
    out_dir = tmp_path / "out"
    main(["sweep", f"--data-root={tmp_path}", f"--out-dir={out_dir}", "--severities=1",
          "--metrics=msp,energy", "--batch-size=12", "--device=cpu", "--seed=2", "--stats"])
    text = capsys.readouterr().out.strip().splitlines()
    stats = json.loads(text[-1])
    assert stats["cells"] == 15 and stats["images"] == 32 and stats["sweep_s"] > 0
    header = text[1].split()
    assert header == ["corruption", "severity", "accuracy", "auroc_msp", "auroc_energy"]
    with open(out_dir / "sweep.json") as fh:
        saved = json.load(fh)
    assert list(saved) == list(harness.CORRUPTIONS)
    # the same sweep through the API, on the same demo model and data
    xtr, ytr, xte, yte = demo.get_data(str(tmp_path))
    model_fn, to_model, _ = demo.get_model(xtr, ytr, device="cpu", seed=2)
    want = harness.corruption_sweep(model_fn, to_model, xte, yte, seed=2, severities=(1,),
                                    metric_names=("msp", "energy"), batch_size=12,
                                    device="cpu")
    assert saved == {n: {"1": v[1]} for n, v in want.items()}
    rows = report.summary_table(want)
    assert report.format_table(rows).splitlines()[1:] == text[2:2 + len(rows)]
    assert sorted(os.listdir(out_dir)) == ["auc_energy.png", "auc_msp.png", "sweep.json"]


def test_report_command(tmp_path, small_demo, capsys):
    out_dir = tmp_path / "out"
    main(["report", f"--data-root={tmp_path}", f"--out-dir={out_dir}", "--device=cpu"])
    text = capsys.readouterr().out
    assert "accuracy:" in text and "shannon_entropy: auroc=" in text
    assert len(os.listdir(out_dir)) == 9  # a histogram a metric


def test_uncertainty_report_and_missing_matplotlib(tmp_path, small_demo, monkeypatch, capsys):
    xtr, ytr, xte, yte = demo.get_data(str(tmp_path))
    model_fn, to_model, model = demo.get_model(xtr, ytr, epochs=1, device="cpu")
    res = workflows.uncertainty_report(model_fn, to_model, xte, yte, device="cpu",
                                       metric_names=("msp", "ratio"))
    ev = harness.evaluate_batched(model_fn, to_model, xte, yte, metric_names=("msp", "ratio"),
                                  device="cpu")
    assert res["accuracy"] == ev["accuracy"] and res["plots"] == []
    assert res["thresholds"] == harness.analyze_uncertainty_thresholds(ev["metrics"],
                                                                       ev["correct"])
    np.testing.assert_array_equal(res["metrics"]["msp"].numpy(), ev["metrics"]["msp"].numpy())
    monkeypatch.setattr(report, "matplotlib_available", lambda: False)
    out_dir = tmp_path / "none"
    main(["sweep", f"--data-root={tmp_path}", f"--out-dir={out_dir}", "--severities=1",
          "--device=cpu"])
    main(["report", f"--data-root={tmp_path}", f"--out-dir={out_dir}", "--device=cpu"])
    assert capsys.readouterr().out.count("no PNG written") == 2
    assert os.listdir(out_dir) == ["sweep.json"]


def test_summary_table_rows():
    sweep = {"fog": {1: {"accuracy": 0.5, "auroc": {"msp": 0.25}},
                     2: {"accuracy": 0.125, "auroc": {"msp": 1.0}}}}
    rows = report.summary_table(sweep)
    assert rows == [{"corruption": "fog", "severity": 1, "accuracy": 0.5, "auroc_msp": 0.25},
                    {"corruption": "fog", "severity": 2, "accuracy": 0.125, "auroc_msp": 1.0}]
    assert report.format_table(rows).splitlines() == [
        "corruption severity accuracy auroc_msp",
        "       fog        1 0.500000  0.250000",
        "       fog        2 0.125000  1.000000"]
    assert report.format_table([]) == ""
