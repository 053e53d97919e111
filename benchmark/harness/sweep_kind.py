"""Traffic kind ``sweep``: the corruption-sweep evaluation
(FINAL_cifar_corrupted.py) through the port's
``evalx.harness.corruption_sweep``, one (corruption, severity) cell a call,
in the fixed order of ``inputs.sweep_cell``, until the first cell that ends
after ``--seconds``.

Traffic parameters: ``corruptions`` (the order), ``batch_size``,
``metrics`` (the logit scores whose AUROC each cell reports),
``uq_extras`` ({"odin_temperature", "odin_eps"}, or absent: with it the
port's ``uq_extras`` path adds ODIN's and the Mahalanobis distance's AUROC,
the distance fitted on the clean set's features at set-up),
``compare_cells`` (how many of the window's cells the reference
recomputes, drawn from the seed) and ``trace_cells`` (how many cells the
traced stretch runs: cells spread evenly over the first round of the
order, so that they hold different corruptions).

A traced run also times the traced stretch's cells again untraced (host
clock, a synchronise before and after): tracing a cell of ~36 000 launches
adds about a third to its host time, so the per-layer metrics divide by the
untraced time (``work["wall_s"]``), not by the traced stretch's length.

``correct`` holds the port's logits and its accuracy and AUROCs against the
reference's on the sampled cells: ``logit_gap`` (the largest logit gap over
max(1, max |logit|)) and ``result_gap`` (the largest gap of the accuracy
or of an AUROC)."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from harness import inputs, trace
from harness.check import Checks, rel_gap
from harness.roofline import macs_per_image
from reference import sweep as rsweep
from reference import uq as ruq


def _attr(path: str):
    """``module:attribute`` of the port."""
    mod, _, name = path.partition(":")
    return getattr(importlib.import_module(mod), name)


def _reference_model(cfg: dict, device, weights: dict | None = None):
    """The configuration's plain network (``reference/<reference_model>.py``)."""
    net = importlib.import_module(f"reference.{cfg['reference_model']}").build(cfg).to(device)
    if weights is not None:
        net.load_state_dict(weights, strict=False)
    return net


def run(r) -> dict:
    from imagetransformations_tpu_torch.evalx import harness as port_sweep
    from imagetransformations_tpu_torch.uq import mahalanobis as port_maha

    cfg, tr, dev, seed = r.config, r.traffic, r.device, r.seed
    n, k = int(r.images), int(cfg["num_classes"])
    batch, metrics = int(tr["batch_size"]), tuple(tr["metrics"])
    order = list(tr["corruptions"])

    r.mark("imports and CUDA")
    x, weights, y, macs = make_inputs(r)
    r.mark("inputs (images, weights, labels)")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the port: its network with the benchmark's weights, its model space
    port_net = _attr(cfg["port_model"])(num_classes=k, device=dev)
    missing, unexpected = port_net.load_state_dict(weights, strict=False)
    if unexpected or any(not m.endswith("num_batches_tracked") for m in missing):
        raise RuntimeError(f"weights do not fit the port's network: {missing} {unexpected}")
    port_net.eval()
    to_space = _attr(cfg["port_model_space"])
    capture: list | None = None  # the evaluation forward's logits of the current cell

    def feats_logits(xm):
        f, lg = port_net.features_and_logits(xm)
        if capture is not None:
            capture.append(lg)
        return f, lg

    def model_fn(xm):
        lg = port_net(xm)
        if capture is not None and extras is None:
            capture.append(lg)
        return lg

    extras = None
    uq = tr.get("uq_extras")
    if uq:
        with torch.no_grad():
            feats = torch.cat([port_net.features(to_space(x[a: a + batch]))
                               for a in range(0, n, batch)])
        st = port_maha.fit(feats)
        del feats
        extras = {"feats_logits_fn": feats_logits, "maha_mean": st.mean,
                  "maha_precision": st.precision, **uq}
    r.mark("the port's network and its Mahalanobis fit")

    def cell(i: int, images: torch.Tensor, labels: torch.Tensor):
        name, sev = inputs.sweep_cell(order, i)
        d = inputs.cell_draws(seed, i, name, sev, images)
        res = port_sweep.corruption_sweep(model_fn, to_space, images, labels,
                                          corruption_names=(name,), severities=(sev,),
                                          batch_size=batch, metric_names=metrics,
                                          uq_extras=extras, cell_draws=lambda nm, sv: d,
                                          device=dev)
        return res[name][sev]

    # warm-up: every (corruption, severity) pair on a slice (their kernels
    # load on first use), then one whole batch through the forward and the
    # scores (cuDNN's choices for the batch's shapes)
    m = min(n, 16)
    for i in range(5 * len(order)):
        cell(i, x[:m], y[:m])
    cell(0, x[:batch], y[:batch])
    r.mark("warm-up")

    stretch: dict = {}
    traced = trace_cells(len(order), int(tr["trace_cells"]))
    wall_s = None
    if r.trace:
        with trace.stretch(stretch, dev):
            for i in traced:
                cell(i, x, y)
        r.sync()
        t = time.perf_counter()
        for i in traced:
            cell(i, x, y)
        r.sync()
        wall_s = time.perf_counter() - t
        r.mark("traced stretch, and its cells untraced")

    # the measured window: whole cells until the first that ends after it
    # (and at least as many as the reference compares)
    results, logits = [], []
    t_start = time.perf_counter()
    r.window_started(t_start)
    i = 0
    while True:
        capture = []
        results.append(cell(i, x, y))
        logits.append(capture)
        capture = None
        i += 1
        if time.perf_counter() - t_start >= r.seconds and i >= int(tr["compare_cells"]):
            break
    t_end = time.perf_counter()
    memory_peak = r.memory_peak()
    del port_net, extras, x
    r.free()

    # the reference, on a sample of the window's cells drawn from the seed
    picked = pick(seed, i, int(tr["compare_cells"]))
    ref = reference(r, weights, y, picked)
    got = {j: dict(results[j], logits=torch.cat(logits[j])[:n]) for j in picked}
    checks = Checks(r.limits)
    failed = compare(checks, got, ref)
    passes = 4 if uq else 1  # ODIN: its forward, its input gradient (one more), its rescoring
    return {
        "attempted": i, "failed": failed, "checks": checks, "memory_peak": memory_peak,
        "end_to_end": {"eval_images_per_s": i * n / (t_end - t_start)},
        "work": {"kind": "sweep", "cells": len(traced), "images_per_cell": n,
                 "passes": passes, "macs_per_image": macs, "wall_s": wall_s},
        "stretch": stretch,
    }


def make_inputs(r):
    """(images, weights, labels, multiply-adds an image) from the seed: the
    weights random with the head standardized on the clean set's features
    (``inputs.standardize_head``), the labels the reference network's clean
    predictions at the published clean accuracy, another class for the
    rest."""
    cfg, dev, seed = r.config, r.device, r.seed
    space, batch = cfg["model_space"], int(r.traffic["batch_size"])
    x = inputs.images(seed, int(r.images), int(cfg["image_size"]), dev)
    net = _reference_model(cfg, dev)
    weights = inputs.weights(net, seed, dev)
    net.load_state_dict(weights, strict=False)
    feats, _ = rsweep.features_and_logits(net, x, space, batch)
    weights = inputs.standardize_head(weights, feats)
    logits = torch.nn.functional.linear(feats, weights["fc.weight"], weights["fc.bias"])
    y = inputs.labels(seed, logits, float(cfg["clean_accuracy"]))
    return x, weights, y, macs_per_image(net, rsweep.model_space(x[:1], space))


def trace_cells(round_len: int, k: int) -> list[int]:
    """The ``k`` cells of the traced stretch, spread evenly over the first
    ``round_len`` cells (one of each corruption)."""
    return sorted({j * round_len // k for j in range(k)})


def pick(seed: int, done: int, k: int) -> list[int]:
    """``k`` of the ``done`` cells, drawn from the seed."""
    rng = np.random.default_rng(inputs.sub_seed(seed, "compare"))
    return sorted(rng.choice(done, size=min(done, k), replace=False).tolist())


def compare(checks: Checks, got: dict, want: dict) -> int:
    """Hold each picked cell's result ({"accuracy", "auroc", "logits"})
    against the reference's: ``logit_gap`` and ``result_gap`` over the
    cells; returns how many cells were beyond a limit."""
    lgap = rgap = 0.0
    failed = 0
    for j, w in want.items():
        g = got[j]
        lg = rel_gap(g["logits"], w["logits"])
        gaps = [abs(g["accuracy"] - w["accuracy"])]
        gaps += [abs(g["auroc"].get(c, np.nan) - v) for c, v in w["auroc"].items()]
        rg = np.inf if np.isnan(gaps).any() else max(gaps)
        failed += int(lg > float(checks.limits["logit_gap"])
                      or rg > float(checks.limits["result_gap"]))
        lgap, rgap = max(lgap, lg), max(rgap, float(rg))
    checks.at_most("logit_gap", lgap)
    checks.at_most("result_gap", rgap)
    return failed


def reference(r, weights: dict, labels: torch.Tensor, picked: list, tf32: bool = False) -> dict:
    """{cell: reference result} of the picked cells, from the inputs made
    again from the seed; ``tf32`` computes it in TF32 (the control)."""
    cfg, tr = r.config, r.traffic
    dev, seed, n = r.device, r.seed, int(r.images)
    space, batch = cfg["model_space"], int(tr["batch_size"])
    x = inputs.images(seed, n, int(cfg["image_size"]), dev)
    net = _reference_model(cfg, dev, weights)
    uq = tr.get("uq_extras")
    maha = None
    if uq:
        feats, _ = rsweep.features_and_logits(net, x, space, batch, tf32)
        with rsweep.precision(tf32):
            maha = ruq.mahalanobis_fit(feats)
    out = {}
    for j in picked:
        name, sev = inputs.sweep_cell(list(tr["corruptions"]), j)
        out[j] = rsweep.evaluate_cell(
            net, x, labels, name, sev, inputs.cell_draws(seed, j, name, sev, x), space=space,
            batch=batch, metrics=tuple(tr["metrics"]),
            odin=(float(uq["odin_temperature"]), float(uq["odin_eps"])) if uq else None,
            maha=maha, tf32=tf32)
    return out


def control(r, done: int) -> Checks:
    """The reference in TF32 in the port's place, on the cells a window of
    ``done`` cells would sample, held against the reference."""
    _, weights, y, _ = make_inputs(r)
    picked = pick(r.seed, done, int(r.traffic["compare_cells"]))
    checks = Checks(r.limits)
    compare(checks, reference(r, weights, y, picked, tf32=True), reference(r, weights, y, picked))
    return checks
