"""End-to-end workflows — the reference's main scripts as APIs (PyTorch).

Counterpart of ``imagetransformations_tpu/workflows.py``. Ported so far:

- ``transform_folder``  <- transformation.py __main__: folder -> 8-transform
  sweep -> save.
- ``chain_folder``      <- the JAX CLI's ``chain`` command: folder -> one
  op-chain -> save.
- ``corrupt_folder``    <- the JAX CLI's ``corrupt`` command: folder -> the
  CIFAR-10-C store's corruptions at severities 1-5 -> PNGs.
- ``uncertainty_report`` <- pipeline/cifar10_histogram4.py and the
  pipeline/metrics/ scripts: every logit metric, its AUROC and Youden
  threshold, and histogram PNGs.
- ``refinement_pipeline`` <- pipeline/cifar_iterative_{mc,ms,ds}.py: metric
  -> Youden threshold -> reverse-FGSM refinement of the flagged inputs ->
  re-evaluation.
- ``tent_sweep``        <- fall_2025/TENT_Pipelines.py:305-408: corruption x
  severity x {baseline, TENT protocols} accuracy matrix.
- ``swag_pipeline``     <- attacks/cifar10-unvertainty/swag/cifar_swag.py:
  collection -> weight samples -> BMA evaluation with uncertainty.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.evalx.harness import corruption_generator


class _Stages:
    """Wall seconds of a folder run's stages into ``stats`` (each stage ends
    after the card has finished the work queued so far), and the device
    stream's time of the compute stage by CUDA events on the card; a stage
    timed more than once adds up."""

    def __init__(self, stats: dict | None, dev: torch.device):
        self.stats = {} if stats is None else stats
        self.dev = dev

    def timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        if name == "compute" and self.dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
        else:
            out = fn(*args)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        key = f"{name}_s"
        self.stats[key] = self.stats.get(key, 0.0) + time.perf_counter() - t0
        if name == "compute" and self.dev.type == "cuda":
            self.stats["compute_event_ms"] = (self.stats.get("compute_event_ms", 0.0)
                                              + start.elapsed_time(stop))
        return out


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _encode(arrs: np.ndarray, out_paths: list[str], native: bool) -> None:
    from imagetransformations_tpu_torch.pipeline import native_io

    if native and arrs.shape[-1] == 3:
        native_io.encode_batch(arrs, out_paths)
        return
    from PIL import Image

    for img, p in zip(arrs, out_paths):
        Image.fromarray(img).save(p)


def _load(in_dir: str, size, native, stages: _Stages):
    """(images on the host, paths, native): the folder decoded, natively
    when ``native`` is None (auto) and the codec builds and ``size`` is
    given."""
    from imagetransformations_tpu_torch.pipeline import native_io
    from imagetransformations_tpu_torch.pipeline.io import load_folder_images

    if native is None:
        native = size is not None and native_io.native_available()
    imgs, paths = stages.timed("decode", load_folder_images, in_dir, size, native)
    stages.stats["images"] = len(paths)
    return imgs, paths, native


def transform_folder(
    in_dir: str,
    out_dir: str,
    generator: torch.Generator | None = None,
    size: tuple[int, int] | None = None,
    native: bool | None = None,
    device: str | torch.device | None = None,
    stats: dict | None = None,
) -> dict:
    """transformation.py __main__ equivalent: folder -> 8-type random-grid
    transform sweep (``apply_all_transformations`` with its default flags)
    -> jpegs named ``{stem}_{type}_{round(v, 2)}_corrupted.jpeg``. Returns
    ``{type: [file names]}``; an empty folder gives ``{}``.

    Runs on ``device`` (None means "cuda", which raises without a GPU;
    "cpu" runs the plain PyTorch versions). ``generator`` draws the grid
    values (a ``torch.Generator`` on that device; by default one seeded
    with 0). ``native`` routes decode AND encode through the multithreaded
    C++ libjpeg path (``pipeline.native_io``); the default auto-detects
    (native when the library builds and ``size`` is given — decode needs a
    target size — PIL otherwise).

    ``stats``: a dict that receives the wall seconds of each stage
    (``decode_s``, ``h2d_s``, ``compute_s`` (the sweep), ``d2h_s``,
    ``encode_s``), the sweep's device-stream time by CUDA events on the card
    (``compute_event_ms``) and ``images``.
    """
    from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations

    dev = entry_device(device, "transform_folder")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    stages = _Stages(stats, dev)
    imgs, paths, native = _load(in_dir, size, native, stages)
    if len(paths) == 0:
        return {}
    x = stages.timed("h2d", lambda: torch.from_numpy(imgs).to(dev))
    res = stages.timed("compute", lambda: apply_all_transformations(x, generator, device=dev))
    host = stages.timed("d2h", lambda: {t: (v.cpu().numpy(), a.cpu().numpy())
                                        for t, (v, a) in res.items()})

    def write():
        os.makedirs(out_dir, exist_ok=True)
        written = {}
        for t, (vals, arrs) in host.items():
            names = [f"{_stem(p)}_{t}_{round(float(v), 2)}_corrupted.jpeg"
                     for p, v in zip(paths, vals)]
            _encode(arrs, [os.path.join(out_dir, fn) for fn in names], native)
            written[t] = names
        return written

    return stages.timed("encode", write)


def chain_folder(
    in_dir: str,
    out_dir: str,
    chain,
    strict_parity: bool = False,
    fast_compile: bool = False,
    generator: torch.Generator | None = None,
    size: tuple[int, int] | None = None,
    native: bool | None = None,
    device: str | torch.device | None = None,
    stats: dict | None = None,
) -> list[str]:
    """A folder through one op-chain (``build_chain_fn``) -> jpegs named
    ``{stem}_chained.jpeg``; returns the paths written (none for an empty
    folder). ``generator`` feeds the noise ops; ``size``, ``native``,
    ``device`` and ``stats`` (``compute_s``: the chain) as in
    ``transform_folder``."""
    from imagetransformations_tpu_torch.pipeline.chain import build_chain_fn

    dev = entry_device(device, "chain_folder")
    fn = build_chain_fn(chain, strict_parity=strict_parity, fast_compile=fast_compile,
                        device=dev)
    stages = _Stages(stats, dev)
    imgs, paths, native = _load(in_dir, size, native, stages)
    if len(paths) == 0:
        return []
    x = stages.timed("h2d", lambda: torch.from_numpy(imgs).to(dev))
    out = stages.timed("compute", fn, x, generator)
    arrs = stages.timed("d2h", lambda: out.cpu().numpy())

    def write():
        os.makedirs(out_dir, exist_ok=True)
        out_paths = [os.path.join(out_dir, f"{_stem(p)}_chained.jpeg") for p in paths]
        _encode(arrs, out_paths, native)
        return out_paths

    return stages.timed("encode", write)


#: the CIFAR-10-C store's 19 generators: the canonical 15, then the store's
#: four extras (not rotation / translation, which are the sweep's)
STORE_CORRUPTIONS = (
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur", "glass_blur",
    "motion_blur", "zoom_blur", "snow", "frost", "fog", "brightness", "contrast",
    "elastic_transform", "pixelate", "jpeg_compression",
    "speckle_noise", "gaussian_blur", "spatter", "saturate",
)


def _unique_stems(paths: list[str], in_dir: str) -> list[str]:
    """A stem an input from its in_dir-relative path (separators -> '_'),
    a duplicate suffixed ``_1``, ``_2``, ... (the JAX CLI's rule)."""
    stems, seen = [], {}
    for p in paths:
        stem = os.path.splitext(os.path.relpath(p, in_dir))[0].replace(os.sep, "_")
        k = seen.get(stem, 0)
        seen[stem] = k + 1
        stems.append(stem if k == 0 else f"{stem}_{k}")
    return stems


def corrupt_folder(
    in_dir: str,
    out_dir: str,
    names=STORE_CORRUPTIONS,
    severities=(1, 2, 3, 4, 5),
    seed: int = 0,
    size: tuple[int, int] | None = None,
    native: bool | None = None,
    device: str | torch.device | None = None,
    stats: dict | None = None,
) -> list[str]:
    """The JAX CLI's ``corrupt`` command as an API: every image of a folder
    through each corruption of ``names`` (``evalx.harness.corrupt``) at each
    of ``severities`` -> PNGs named ``{stem}_{name}_severity{sev}.png``
    (PIL). Returns the file names written (none for an empty folder).

    Each (name, severity) cell draws from its own ``corruption_generator``
    of ``seed``. ``size``, ``native`` (the decode only: the outputs are
    PNGs), ``device`` and ``stats`` as in ``transform_folder``; the compute,
    copy and encode stages add up over the cells."""
    from PIL import Image

    from imagetransformations_tpu_torch.evalx.harness import corrupt

    dev = entry_device(device, "corrupt_folder")
    stages = _Stages(stats, dev)
    imgs, paths, _ = _load(in_dir, size, native, stages)
    if len(paths) == 0:
        return []
    stems = _unique_stems(paths, in_dir)
    x = stages.timed("h2d", lambda: torch.from_numpy(imgs).to(dev))
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in names:
        for sev in severities:
            g = corruption_generator(seed, name, sev, dev)
            out = stages.timed("compute", corrupt, x, name, sev, g)
            arrs = stages.timed("d2h", lambda: out.cpu().numpy())

            def write():
                for arr, stem in zip(arrs, stems):
                    fn = f"{stem}_{name}_severity{sev}.png"
                    Image.fromarray(arr).save(os.path.join(out_dir, fn))
                    written.append(fn)

            stages.timed("encode", write)
    return written


def uncertainty_report(
    model_fn, to_model_space, images_u8, labels, out_dir: str | None = None,
    metric_names=("shannon_entropy", "msp", "margin", "ratio", "energy",
                  "doctor_alpha", "doctor_beta", "max_logit", "least_confidence"),
    device: str | torch.device | None = None,
):
    """Every listed logit metric, its AUROC and Youden threshold for error
    detection (``evaluate_batched``, ``analyze_uncertainty_thresholds``), and
    with ``out_dir`` a histogram PNG per metric. Returns ``{"accuracy",
    "thresholds", "metrics", "plots"}``: ``plots`` lists the PNGs written,
    none where matplotlib is missing. Runs on ``device`` (None means
    "cuda", which raises without a GPU)."""
    from imagetransformations_tpu_torch.evalx import report
    from imagetransformations_tpu_torch.evalx.harness import (
        analyze_uncertainty_thresholds,
        evaluate_batched,
    )

    res = evaluate_batched(model_fn, to_model_space, images_u8, labels,
                           metric_names=tuple(metric_names), device=device)
    table = analyze_uncertainty_thresholds(res["metrics"], res["correct"])
    plots = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        if report.matplotlib_available():
            for m, score in res["metrics"].items():
                plots.append(report.plot_uncertainty_histogram(
                    score, res["correct"] > 0.5, threshold=table[m]["threshold"], title=m,
                    out_path=os.path.join(out_dir, f"{m}.png")))
    return {"accuracy": res["accuracy"], "thresholds": table, "metrics": res["metrics"],
            "plots": plots}


def refinement_pipeline(
    model_fn, to_model_space, images_u8, labels,
    metric: str = "shannon_entropy", eps: float = 0.03, max_iters: int = 10,
    msp_stop: float = 0.998, device: str | torch.device | None = None,
):
    """cifar_iterative_* equivalent: score every input by ``metric``, flag
    those above its Youden threshold for error detection, refine the
    flagged inputs by reverse FGSM (``adapt.refine.refine_batch``), and
    compare the predictions before and after (``evalx.analysis
    .flip_analysis``). Returns ``{"threshold", "n_flagged",
    "refine_iters", **flip_analysis}``. As in the JAX package the
    model-space inputs are refined under ``refine_batch``'s default clip
    [0, 1], whatever range ``to_model_space`` gives them. Runs on
    ``device`` (None means "cuda", which raises without a GPU)."""
    from imagetransformations_tpu_torch.adapt.refine import refine_batch
    from imagetransformations_tpu_torch.evalx.analysis import flip_analysis
    from imagetransformations_tpu_torch.uq import metrics as um
    from imagetransformations_tpu_torch.uq.calibration import youden_threshold

    dev = entry_device(device, "refinement_pipeline")
    x = to_model_space(to_device(images_u8, dev))
    y = to_device(labels, dev)
    with torch.no_grad():
        logits = model_fn(x)
        correct = (torch.argmax(logits, -1) == y).to(torch.float32)
        score = um.LOGIT_METRICS[metric](logits)
        if metric in um.CONFIDENCE_METRICS:
            score = -score
        thr = youden_threshold(score, 1.0 - correct)
        flagged = score > thr
    x_ref, iters = refine_batch(model_fn, x, flagged, eps=eps, max_iters=max_iters,
                                msp_stop=msp_stop)
    with torch.no_grad():
        logits_after = model_fn(x_ref)
    return {
        "threshold": float(thr),
        "n_flagged": int(torch.sum(flagged)),
        "refine_iters": int(iters),
        **flip_analysis(logits, logits_after, y),
    }


def tent_sweep(
    model, corruptions, severities, clean_images_u8, labels, to_model_space,
    seed: int = 0, lr=2.5e-4, batch_size: int = 256,
    protocols=("baseline", "continuous", "reset", "conditional"),
    image_entropy_threshold: float = 1.16, model_apply_eval=None, cell_draws=None,
    device: str | torch.device | None = None,
):
    """Corruption x severity x protocol accuracy matrix (TENT_Pipelines.py
    :305-408): ``result[corruption][severity][protocol]``.

    Each cell corrupts the clean set with ``evalx.harness.corrupt`` and its
    own generator, ``corruption_generator(seed, name, severity)``, or with
    the explicit draws ``cell_draws(name, severity)`` returns (as
    ``corruption_sweep`` does); cuts it into batches of ``batch_size`` (the
    last may be ragged), each a ``(model_space, raw_u8)`` tuple so that the
    'conditional' protocol's pixel-entropy gate sees the corrupted images;
    and runs each protocol from ``model``'s own parameters
    (``adapt.tent.evaluate_with_tent``; the module is not changed).

    'baseline' is the un-adapted accuracy: ``model_apply_eval(x) -> logits``
    (the eval-mode forward with the running statistics, as the reference's
    ``evaluate_baseline``, TENT_Pipelines.py:146-160), or without it the
    batch-statistics forward of each batch, which already holds TENT's
    main lever (BatchNorm recalibrated on the corrupted batch) and so
    understates the adapted-vs-baseline gap. ``lr`` is one float or a
    ``{protocol: lr}`` dict; the reference uses 2.5e-4 for continuous and
    1e-3 for reset and conditional (TENT_Pipelines.py:353-366). Runs on
    ``device`` (None means "cuda", which raises without a GPU); ``model``
    must be there.
    """
    from imagetransformations_tpu_torch.adapt.tent import batch_stats_forward, evaluate_with_tent
    from imagetransformations_tpu_torch.core.precision import full_f32
    from imagetransformations_tpu_torch.evalx.harness import corrupt

    dev = entry_device(device, "tent_sweep")
    x, y = to_device(clean_images_u8, dev), to_device(labels, dev)
    if model_apply_eval is None:
        params = dict(model.named_parameters())
        forward = batch_stats_forward(model)
        model_apply_eval = lambda xb: forward(params, xb)  # noqa: E731
    results: dict = {}
    for name in corruptions:
        results[name] = {}
        for sev in severities:
            if cell_draws is None:
                imgs = corrupt(x, name, sev, corruption_generator(seed, name, sev, dev))
            else:
                imgs = corrupt(x, name, sev, None, **{
                    k: to_device(v, dev) for k, v in cell_draws(name, sev).items()})
            xs = to_model_space(imgs)
            starts = range(0, xs.shape[0], batch_size)
            batches = [(xs[i: i + batch_size], imgs[i: i + batch_size]) for i in starts]
            lbatches = [y[i: i + batch_size] for i in starts]
            row = {}
            for proto in protocols:
                if proto == "baseline":
                    with torch.no_grad(), full_f32():
                        correct = sum(torch.sum(torch.argmax(model_apply_eval(xb), -1) == yb)
                                      for (xb, _), yb in zip(batches, lbatches))
                    row[proto] = int(correct) / max(int(xs.shape[0]), 1)
                else:
                    row[proto] = evaluate_with_tent(
                        model, batches, lbatches,
                        lr=float(lr[proto] if isinstance(lr, dict) else lr), protocol=proto,
                        image_entropy_threshold=image_entropy_threshold, device=dev)
            results[name][sev] = row
    return results


def swag_pipeline(
    model, train_iter_fn, eval_images, generator: torch.Generator | None = None,
    num_weight_samples: int = 30, eval_mc_samples: int = 10, max_rank: int = 20,
    lr: float = 1e-4, draws: list | None = None,
    device: str | torch.device | None = None,
):
    """SWAG collection -> sampling -> BMA uncertainty (cifar_swag.py:65-253):
    ``models.training.swag_collect`` trains ``model`` (on ``device``) in
    place over ``train_iter_fn()``'s (x, y) batches, ``swag.sample_many``
    draws ``num_weight_samples`` weight samples (from ``draws``, one
    ``swag.draw``-shaped dict a sample, else from ``generator``), and the
    first ``eval_mc_samples`` of them evaluate ``eval_images`` (model space)
    with the collected BatchNorm statistics. Returns ``{"probs",
    "entropy"`` (nats)``, "one_minus_max", "jsd", "variance",
    "swag_state"}``. ``device``: None means "cuda", which raises without a
    GPU."""
    from imagetransformations_tpu_torch.models.training import swag_collect
    from imagetransformations_tpu_torch.uq import mc as umc
    from imagetransformations_tpu_torch.uq import swag

    dev = entry_device(device, "swag_pipeline")
    batches = ((to_device(x, dev), to_device(y, dev)) for x, y in train_iter_fn())
    model, state = swag_collect(model, batches, lr=lr, max_rank=max_rank)
    stacked = swag.sample_many(state, num_weight_samples, generator, draws=draws)
    take = {k: v[:eval_mc_samples] for k, v in stacked.items()}
    mc_logits = swag.bma_logits(model, take, to_device(eval_images, dev))  # [S, B, C]
    with torch.no_grad():
        probs = torch.mean(torch.softmax(mc_logits, -1), dim=0)
        return {
            "probs": probs,
            "entropy": umc.predictive_entropy(mc_logits, base2=False),
            "one_minus_max": 1.0 - torch.amax(probs, -1),
            "jsd": umc.jensen_shannon(mc_logits),
            "variance": umc.mc_variance(mc_logits),
            "swag_state": state,
        }
