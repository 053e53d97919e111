"""Reporting: uncertainty histograms, AUROC line plots, summary tables.

Counterpart of ``imagetransformations_tpu/evalx/report.py:17-83``:
- pipeline/metrics/energy.py:48-90 and FINAL_cifar_corrupted.py:116-168 ->
  ``plot_uncertainty_histogram``: 20-bin correct-vs-incorrect bars with a
  threshold line, saved as a PNG;
- FINAL_cifar_corrupted's severity AUROC plot -> ``plot_severity_aucs``;
- pipeline/cifar_iterative_mc.py:524-528's pandas table -> ``summary_table``
  (rows as dicts; the port does not depend on pandas) and ``format_table``
  (the JAX table's columns as text).

The plots import matplotlib when called; ``matplotlib_available`` says
whether they can run.
"""

from __future__ import annotations

import importlib.util

import numpy as np


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def plot_uncertainty_histogram(
    scores, correct, threshold: float | None = None, n_bins: int = 20,
    title: str = "", out_path: str | None = None,
):
    """20-bin correct/incorrect histogram of an uncertainty score (tensors
    or arrays); saved to ``out_path`` (returned), else the figure."""
    plt = _pyplot()
    scores = _numpy(scores)
    correct = _numpy(correct).astype(bool)
    edges = np.linspace(scores.min(), scores.max() + 1e-9, n_bins + 1)
    centers = (edges[:-1] + edges[1:]) / 2
    width = (edges[1] - edges[0]) * 0.4
    c_hist, _ = np.histogram(scores[correct], bins=edges)
    i_hist, _ = np.histogram(scores[~correct], bins=edges)
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.bar(centers - width / 2, c_hist, width=width, label="correct", color="#2a9d8f")
    ax.bar(centers + width / 2, i_hist, width=width, label="incorrect", color="#e76f51")
    if threshold is not None:
        ax.axvline(threshold, color="k", linestyle="--", label=f"threshold={threshold:.3g}")
    ax.set_xlabel("uncertainty")
    ax.set_ylabel("count")
    ax.set_title(title)
    ax.legend()
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def plot_severity_aucs(sweep_result: dict, metric: str, out_path: str | None = None):
    """AUROC vs severity, one line per corruption (FINAL_cifar_corrupted)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    for name, sev_map in sweep_result.items():
        sevs = sorted(sev_map)
        ax.plot(sevs, [sev_map[s]["auroc"][metric] for s in sevs], marker="o", label=name)
    ax.set_xlabel("severity")
    ax.set_ylabel(f"AUROC ({metric})")
    ax.set_ylim(0.0, 1.0)
    ax.legend(fontsize=7, ncol=2)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def summary_table(sweep_result: dict) -> list[dict]:
    """A sweep flattened to rows: ``corruption``, ``severity``, ``accuracy``
    and ``auroc_{metric}`` for each metric (the JAX DataFrame's columns)."""
    rows = []
    for name, sev_map in sweep_result.items():
        for sev, res in sev_map.items():
            row = {"corruption": name, "severity": sev, "accuracy": res["accuracy"]}
            row.update({f"auroc_{m}": v for m, v in res["auroc"].items()})
            rows.append(row)
    return rows


def format_table(rows: list[dict]) -> str:
    """The rows as right-aligned text columns, floats to 6 digits (as
    ``DataFrame.to_string(index=False)`` prints them)."""
    if not rows:
        return ""
    cols = list(rows[0])

    def cell(v):
        return f"{v:.6f}" if isinstance(v, float) else str(v)

    body = [[cell(r.get(c, "")) for c in cols] for r in rows]
    widths = [max(len(c), *(len(b[i]) for b in body)) for i, c in enumerate(cols)]
    lines = [" ".join(c.rjust(w) for c, w in zip(cols, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(b, widths)) for b in body]
    return "\n".join(lines)
