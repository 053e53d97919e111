"""Corruption-sweep evaluation harness (PyTorch): corruptions x severities
x metrics.

Counterpart of ``imagetransformations_tpu/evalx/harness.py``:
- ``CORRUPTIONS`` (the reference's 15 canonical CIFAR-10-C corruptions,
  attacks/uncertainty/FINAL_cifar_corrupted.py:22-27, in its order),
  ``EXTRA_CORRUPTIONS`` (the store's four more, and the sweep-only rotation
  and translation) and ``corrupt``, with the JAX package's names, order and
  severity values. Every corruption is generated on the device
  (``ops.corruptions``); ``rotation`` on a u8 batch on the card runs the
  hand-written NEAREST rotation kernel (``csrc/rotate_nearest.cu``).
- ``evaluate_batched``: one forward over fixed-size batches (the last one
  padded by repeating its last row, the padded logits dropped), then the
  accuracy and every per-sample metric.
- ``corruption_sweep`` (FINAL_cifar_corrupted.py): per (corruption,
  severity) cell the accuracy and the error-detection AUROC of each metric,
  with ``uq_extras`` also ODIN's and the Mahalanobis distance's
  (FINAL_cifar_corrupted.py:237-262). Each cell draws from its own
  generator, seeded from (``seed``, the cell) as the ``corrupt`` CLI's.
- ``analyze_uncertainty_thresholds`` (pipeline/cifar_iterative_mc.py:
  174-219): the threshold by Youden's J and the flagged counts per metric.

- ``evaluate_sharded`` and the sweep's ``mesh=`` path: the same over a
  one-process device mesh (``pipeline.sharding``) or the ranks of a process
  mesh (``core.mesh.ProcessMesh``): the batch padded to the axis by
  repeating its last row, the corruption generated on the padded batch,
  the forward run on each shard with a model replica a device, the logits
  gathered and the padding trimmed.

Each sweep cell is span ``sweep.cell`` (corruption, severity), with
children ``sweep.generate``, ``sweep.forward`` and ``sweep.odin`` (each
batch's) and ``sweep.stats``; its reads of the results go through
``utils.profiling.host_read`` (both recorded only while a profiler runs).

The JAX package's jit caches have no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.ops import corruptions as cr
from imagetransformations_tpu_torch.ops import noise as nz
from imagetransformations_tpu_torch.ops import warp as wp
from imagetransformations_tpu_torch.uq import mahalanobis as _maha
from imagetransformations_tpu_torch.uq import metrics as um
from imagetransformations_tpu_torch.uq.calibration import auroc, youden_threshold
from imagetransformations_tpu_torch.uq.odin import odin_uncertainty
from imagetransformations_tpu_torch.utils import profiling


def _elastic(x, v, g, **draws):
    h, w = int(x.shape[-3]), int(x.shape[-2])
    a, s, aa = cr.elastic_affine_pixels(h, w, *v)
    return cr.elastic_transform_affine(x, a, s, aa, generator=g, **draws)


#: corruption name -> (fn(images_u8, severity_value, generator, **draws),
#: [5 severity values]); the keys are the canonical CIFAR-10-C list in the
#: reference's order. ``draws`` are the op's explicit-draw keywords.
CORRUPTIONS: dict[str, tuple[Callable, list]] = {
    # CIFAR-10-C's noise severities; the TransformationPool's lists are
    # about twice as strong (the ops take any severity)
    "gaussian_noise": (
        lambda x, v, g, **d: nz.gaussian_noise_01(x, v, generator=g, **d),
        cr.GAUSSIAN_NOISE_SEV,
    ),
    "shot_noise": (
        lambda x, v, g, **d: nz.shot_noise(x, v, generator=g, **d),
        cr.SHOT_NOISE_SEV,
    ),
    "impulse_noise": (
        lambda x, v, g, **d: nz.impulse_noise(x, v, generator=g, **d),
        cr.IMPULSE_NOISE_SEV,
    ),
    "defocus_blur": (
        # CIFAR-10-C's tiny anti-aliased disk, not the TransformationPool's
        # PIL GaussianBlur (stencil.pil_gaussian_blur)
        lambda x, v, g, **d: cr.defocus_blur_disk(x, *v),
        cr.DEFOCUS_SEV,
    ),
    "glass_blur": (
        lambda x, v, g, **d: cr.glass_blur(x, *v, generator=g, **d),
        cr.GLASS_BLUR_SEV,
    ),
    "motion_blur": (
        lambda x, v, g, **d: cr.motion_blur_directional(x, int(v[0]), float(v[1]),
                                                        generator=g, **d),
        cr.MOTION_SEV,
    ),
    "zoom_blur": (
        lambda x, v, g, **d: cr.zoom_blur(x, float(v)),
        cr.ZOOM_BLUR_SEV,
    ),
    "snow": (
        lambda x, v, g, **d: cr.snow(x, *v, generator=g, **d),
        cr.SNOW_SEV,
    ),
    "frost": (
        lambda x, v, g, **d: cr.frost(x, *v, generator=g, **d),
        cr.FROST_SEV,
    ),
    "fog": (
        lambda x, v, g, **d: cr.fog(x, *v, generator=g, **d),
        cr.FOG_SEV,
    ),
    # HSV-value brightness and mean-preserving contrast (CIFAR-10-C's
    # recipes), not the sweep's PIL / convertScaleAbs ops
    "brightness": (
        lambda x, v, g, **d: cr.brightness_hsv(x, float(v)),
        cr.BRIGHTNESS_SEV,
    ),
    "contrast": (
        lambda x, v, g, **d: cr.contrast_meanpreserve(x, float(v)),
        cr.CONTRAST_SEV,
    ),
    "elastic_transform": (
        _elastic,
        cr.ELASTIC_AFFINE_SEV,
    ),
    "pixelate": (
        lambda x, v, g, **d: cr.pixelate(x, float(v)),
        cr.PIXELATE_SEV,
    ),
    "jpeg_compression": (
        lambda x, v, g, **d: cr.jpeg_compression(x, int(v)),
        cr.JPEG_SEV,
    ),
}

#: non-canonical extras, usable by name: the first four complete the
#: reference's CIFAR-10-C store to its 19 corruptions; rotation and
#: translation are the sweep's
EXTRA_CORRUPTIONS: dict[str, tuple[Callable, list]] = {
    "speckle_noise": (
        lambda x, v, g, **d: cr.speckle_noise(x, v, generator=g, **d),
        cr.SPECKLE_SEV,
    ),
    "gaussian_blur": (
        lambda x, v, g, **d: cr.gaussian_blur_sigma_op(x, float(v)),
        cr.GAUSSIAN_BLUR_SEV,
    ),
    "spatter": (
        lambda x, v, g, **d: cr.spatter(x, *v, generator=g, **d),
        cr.SPATTER_SEV,
    ),
    "saturate": (
        # HSV-saturation scale and shift (CIFAR-10-C), not PIL enhance_color
        lambda x, v, g, **d: cr.saturate_hsv(x, *v),
        cr.SATURATE_SEV,
    ),
    "rotation": (
        lambda x, v, g, **d: wp.apply_rotation(x, float(v)),
        [5.0, 10.0, 15.0, 20.0, 22.5],
    ),
    "translation": (
        lambda x, v, g, **d: wp.apply_translation(x, float(v)),
        [2.0, 4.0, 6.0, 8.0, 10.0],
    ),
}


def corrupt(images_u8: torch.Tensor, name: str, severity: int,
            generator: torch.Generator | None = None, **draws) -> torch.Tensor:
    """Corruption ``name`` at severity 1..5 of a u8 NHWC batch, on its
    device. ``generator`` (a ``torch.Generator`` on that device) draws what
    the corruption needs; ``draws`` pass the op's explicit-draw keywords
    instead (``noise=``, ``offsets=``, ``draws=``, ...; ``draw=`` for
    ``shot_noise``, ``u=`` for ``impulse_noise``)."""
    fn, sevs = CORRUPTIONS.get(name) or EXTRA_CORRUPTIONS[name]
    return fn(images_u8, sevs[severity - 1], generator, **draws)


def numpy_draws(images_u8: np.ndarray, name: str, severity: int,
                rng: np.random.Generator) -> dict:
    """The explicit draws of one (corruption, severity) cell, made with
    numpy on the host in the shapes and distributions the op draws from a
    generator: a dict of the op's draw keywords (empty for a deterministic
    corruption), to pass to ``corrupt`` so that two devices, or this
    package and the JAX package, see the same randomness. ``shot_noise``'s
    Poisson counts depend on ``images_u8`` (NHWC)."""
    n, h, w, c = images_u8.shape
    v = (CORRUPTIONS.get(name) or EXTRA_CORRUPTIONS[name])[1][severity - 1]

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def uniform(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    if name in ("gaussian_noise", "speckle_noise"):
        return {"noise": normal(n, h, w, c)}
    if name == "shot_noise":
        return {"draw": rng.poisson(images_u8 / 255.0 * v).astype(np.float32)}
    if name == "impulse_noise":
        return {"u": uniform(0.0, 1.0, n, h, w)}
    if name == "glass_blur":
        _, d, iterations = v
        return {"offsets": rng.integers(-d, d, (iterations, n, h, w, 2)).astype(np.int32)}
    if name == "motion_blur":
        return {"angles_deg": uniform(-45.0, 45.0, n)}
    if name == "snow":
        return {"g_noise": normal(n, h, w), "angles_deg": uniform(-135.0, -45.0, n)}
    if name == "frost":
        return {"u_seed": uniform(0.0, 1.0, n, h, w), "u_amp": uniform(0.0, 1.0, n, h, w),
                "g_noise": normal(n, h, w)}
    if name == "fog":
        size = cr.fog_size(h, w)
        return {"draws": uniform(-1.0, 1.0, n, cr.plasma_levels(size), size, size)}
    if name == "elastic_transform":
        alpha, _, aa = cr.elastic_affine_pixels(h, w, *v)
        out = {"jitter": uniform(-aa, aa, n, 3, 2)}
        if alpha > 0:
            out["disp"] = uniform(-1.0, 1.0, n, h, w, 2)
        return out
    if name == "spatter":
        return {"g_noise": normal(n, h, w)}
    return {}


def corruption_generator(seed: int, name: str, severity: int,
                         device: torch.device) -> torch.Generator:
    """The generator of one (corruption, severity) cell: seeded from
    (``seed``, the cell's place in the fixed table of every known
    corruption x severities 1-5), so a cell draws the same numbers whichever
    other cells a run asks for."""
    cell = [*CORRUPTIONS, *EXTRA_CORRUPTIONS].index(name) * 5 + severity - 1
    state = np.random.SeedSequence([int(seed), cell]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


DEFAULT_METRICS: tuple[str, ...] = (
    "shannon_entropy", "msp", "least_confidence", "margin", "ratio",
    "max_logit", "energy", "doctor_alpha", "doctor_beta",
)


def _batches(images_u8: torch.Tensor, batch_size: int):
    """Fixed-size batches of ``images_u8``, the last padded by repeating its
    last row; yields (batch, number of real rows)."""
    n = int(images_u8.shape[0])
    bs = min(int(batch_size), n)
    for i in range(0, n, bs):
        xb = images_u8[i: i + bs]
        real = int(xb.shape[0])
        if real < bs:
            xb = torch.cat([xb, xb[-1:].expand(bs - real, *xb.shape[1:])])
        yield xb, real


def _forward_all(model_fn, to_model_space, images_u8: torch.Tensor, batch_size: int):
    """Logits of the whole dataset, batch by batch (no autograd)."""
    out = []
    with torch.no_grad():
        for xb, real in _batches(images_u8, batch_size):
            with profiling.span("sweep.forward"):
                out.append(model_fn(to_model_space(xb))[:real])
    return torch.cat(out)


def _forward_uq_all(model_fn, feats_logits_fn, to_model_space, images_u8: torch.Tensor,
                    batch_size: int, odin_temperature: float = 1000.0,
                    odin_eps: float = 0.0014):
    """(logits, penultimate features, ODIN uncertainty) of the whole dataset:
    per batch the feature forward, then ODIN's input-gradient backward and
    its perturbed forward at temperature T (the reference computes ODIN
    beside the logit metrics, FINAL_cifar_corrupted.py:237-262)."""
    lg, ft, od = [], [], []
    for xb, real in _batches(images_u8, batch_size):
        with profiling.span("sweep.forward"):
            xm = to_model_space(xb)
            with torch.no_grad():
                feats, logits = feats_logits_fn(xm)
        with profiling.span("sweep.odin"):
            u = odin_uncertainty(model_fn, xm, float(odin_temperature), float(odin_eps))
        lg.append(logits[:real])
        ft.append(feats[:real])
        od.append(u[:real])
    return torch.cat(lg), torch.cat(ft), torch.cat(od)


def _finalize_eval(logits, labels, metric_names):
    with torch.no_grad():
        correct = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
        metrics = {m: um.LOGIT_METRICS[m](logits) for m in metric_names}
    return {"accuracy": float(torch.mean(correct)), "correct": correct, "logits": logits,
            "metrics": metrics}


def evaluate_batched(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    to_model_space: Callable[[torch.Tensor], torch.Tensor],
    images_u8,
    labels,
    batch_size: int = 256,
    metric_names: tuple[str, ...] = DEFAULT_METRICS,
    device: str | torch.device | None = None,
):
    """Accuracy and per-sample metric tensors over a dataset: ``model_fn``
    (model space -> logits) after ``to_model_space`` (u8 NHWC batch -> model
    space) over fixed batches of ``batch_size``, then one finalize. Returns
    ``{"accuracy": float, "correct": [N], "logits": [N, C], "metrics": {name:
    [N]}}`` on ``device`` (None means "cuda", which raises without a GPU).
    ``images_u8`` and ``labels`` are numpy arrays or tensors."""
    dev = entry_device(device, "evaluate_batched")
    x, y = to_device(images_u8, dev), to_device(labels, dev)
    return _finalize_eval(_forward_all(model_fn, to_model_space, x, batch_size), y,
                          metric_names)


def _pad_to(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """``x`` padded to a multiple of ``multiple`` rows by repeating its last
    row (always there, even where the pad exceeds the rows); (x, pad)."""
    pad = (-int(x.shape[0])) % multiple
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x, pad


def _sharded_forward(models, to_model_space, xs) -> torch.Tensor:
    """Logits of a batch-sharded u8 batch, each shard on its slot's device
    with its slot's model, gathered on the first slot's device (on a
    process mesh: on every rank, by ``all_gather``)."""
    from imagetransformations_tpu_torch.pipeline.sharding import ShardedBatch

    with torch.no_grad():
        parts = tuple(m(to_model_space(s)) for m, s in zip(models, xs.shards))
    return ShardedBatch(parts, xs.mesh, xs.axis).gather()


def evaluate_sharded(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    to_model_space: Callable[[torch.Tensor], torch.Tensor],
    images_u8,
    labels,
    mesh,
    axis: str = "data",
    batch_size: int | None = None,
    metric_names: tuple[str, ...] = DEFAULT_METRICS,
    corrupt_fn: Callable[[torch.Tensor, torch.Generator | None], torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
):
    """Data-parallel ``evaluate_batched`` over a one-process device mesh
    (``pipeline.sharding.Mesh``; the reference's DataParallel wrap,
    attacks/fgsm.py:58) or a process mesh
    (``core.mesh.ProcessMesh``).

    The dataset goes in batches of ``batch_size`` (default: all of it, at
    least one row a shard) on the first slot's device. Each batch is padded
    to a multiple of ``mesh.shape[axis]`` by repeating its last row;
    ``corrupt_fn(batch_u8, generator) -> batch_u8`` (optional) runs on the
    padded batch, before the forward, as in JAX; then the batch is split
    over the slots, each shard runs ``model_fn`` (an ``nn.Module`` is copied
    once to each other device, ``pipeline.sharding.model_replicas``) and
    the padded logits are trimmed. Returns ``evaluate_batched``'s dict on
    the first slot's device. As in JAX, padding changes the shape of the
    corruption's draws, so a sharded generation equals the unsharded one
    where each batch divides the axis. ``generator`` defaults to one seeded
    with 0 (JAX: ``key(0)``).

    On a process mesh every rank holds the whole dataset and generates the
    whole padded batch (the same draws on every rank), runs the forward on
    its shard with rank 0's weights (``model_replicas``), and gathers the
    logits: every rank returns the whole dict, on its own device."""
    from imagetransformations_tpu_torch.pipeline.sharding import (
        home_device, model_replicas, shard_images)

    ndev = mesh.shape[axis]
    dev = home_device(mesh)
    x, y = to_device(images_u8, dev), to_device(labels, dev)
    n = int(x.shape[0])
    batch_size = max(int(n if batch_size is None else batch_size), ndev)
    if corrupt_fn is not None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    models = model_replicas(model_fn, mesh)
    out = []
    for i in range(0, n, batch_size):
        xb, pad = _pad_to(x[i: i + batch_size], ndev)
        if corrupt_fn is not None:
            xb = corrupt_fn(xb, generator)
        lg = _sharded_forward(models, to_model_space, shard_images(xb, mesh, axis))
        out.append(lg[: lg.shape[0] - pad])
    return _finalize_eval(torch.cat(out), y, metric_names)


def _error_aurocs(logits, labels, metric_names):
    """(accuracy, errors, AUROC of each metric against the errors): the
    confidence metrics are negated so that higher means more likely wrong."""
    correct = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    errors = 1.0 - correct
    aucs = []
    for m in metric_names:
        score = um.LOGIT_METRICS[m](logits)
        aucs.append(auroc(-score if m in um.CONFIDENCE_METRICS else score, errors))
    return torch.mean(correct), errors, aucs


def corruption_sweep(
    model_fn,
    to_model_space,
    clean_images_u8,
    labels,
    seed: int = 0,
    corruption_names: tuple[str, ...] | None = None,
    severities: tuple[int, ...] = (1, 2, 3, 4, 5),
    batch_size: int = 256,
    metric_names: tuple[str, ...] = ("shannon_entropy", "msp", "margin", "energy"),
    mesh=None,
    mesh_axis: str = "data",
    uq_extras: dict | None = None,
    cell_draws: Callable[[str, int], dict] | None = None,
    device: str | torch.device | None = None,
):
    """FINAL_cifar_corrupted-style sweep -> ``result[corruption][severity] =
    {"accuracy": float, "auroc": {metric: float}}``; the AUROC targets error
    detection (the metric against "the prediction is wrong").

    Each cell corrupts the clean set with ``corrupt`` and its own generator,
    ``corruption_generator(seed, name, severity)``, or, with ``cell_draws``,
    with the explicit draws ``cell_draws(name, severity)`` returns (the
    keywords of ``corrupt``, e.g. from ``numpy_draws``: the same randomness on
    every device); then one ``evaluate_batched`` forward and the cell's
    statistics.

    ``uq_extras`` adds ODIN's and the Mahalanobis distance's AUROC columns
    ("odin", "mahalanobis"; FINAL_cifar_corrupted.py:237-262): a dict with
    ``feats_logits_fn`` (model space -> (penultimate features, logits)),
    ``maha_mean`` / ``maha_precision`` (a clean-feature fit,
    ``uq.mahalanobis.fit``) and optionally ``odin_temperature`` /
    ``odin_eps`` (1000 / 0.0014, uncertainty_metrics.py:69-94).

    Runs on ``device`` (None means "cuda", which raises without a GPU).

    With ``mesh`` (a ``pipeline.sharding.Mesh``), the multi-device form of
    the reference's 15 x 5 x 10k sweep: the clean set is padded once to a
    multiple of ``mesh.shape[mesh_axis]`` by repeating its last row, each
    cell generated on the padded set (on ``device``, by default the mesh's
    first slot; ``cell_draws`` must then give draws for the padded set),
    and the forward runs on each shard with a model replica a device
    (``evaluate_sharded``'s), the padding trimmed. Where the set divides
    the axis each cell generates what the one-device sweep generates. On a
    process mesh (``core.mesh.ProcessMesh``) every rank
    generates the whole cell from the same seed and keeps its rows for its
    forward; the logits are gathered, so every rank returns the whole
    result (``device`` defaults to the rank's own). ``uq_extras`` is a
    one-device path: with a mesh it raises.
    """
    from imagetransformations_tpu_torch.pipeline.sharding import (
        home_device, model_replicas, shard_images)

    if mesh is not None and uq_extras is not None:
        raise ValueError("corruption_sweep: uq_extras is a single-device path; pass mesh=None")
    if mesh is not None and device is None:
        dev = home_device(mesh)
    else:
        dev = entry_device(device, "corruption_sweep")
    x, y = to_device(clean_images_u8, dev), to_device(labels, dev)
    pad = 0
    if mesh is not None:
        x, pad = _pad_to(x, mesh.shape[mesh_axis])
        models = model_replicas(model_fn, mesh)
    names = corruption_names or tuple(CORRUPTIONS)
    metric_names = tuple(metric_names)
    if uq_extras is not None:
        state = _maha.MahalanobisState(to_device(uq_extras["maha_mean"], dev),
                                       to_device(uq_extras["maha_precision"], dev))
        odin_t = uq_extras.get("odin_temperature", 1000.0)
        odin_e = uq_extras.get("odin_eps", 0.0014)
    out: dict = {}
    for name in names:
        out[name] = {}
        for sev in severities:
            with profiling.span("sweep.cell", corruption=name, severity=sev):
                with profiling.span("sweep.generate"):
                    if cell_draws is None:
                        imgs = corrupt(x, name, sev, corruption_generator(seed, name, sev, dev))
                    else:
                        imgs = corrupt(x, name, sev, None, **{
                            k: to_device(v, dev) for k, v in cell_draws(name, sev).items()})
                if mesh is not None:
                    with profiling.span("sweep.forward"):
                        logits = _sharded_forward(models, to_model_space,
                                                  shard_images(imgs, mesh, mesh_axis))
                    logits = logits[: logits.shape[0] - pad]
                    cols = metric_names
                elif uq_extras is None:
                    logits = _forward_all(model_fn, to_model_space, imgs, batch_size)
                    cols = metric_names
                else:
                    logits, feats, od = _forward_uq_all(
                        model_fn, uq_extras["feats_logits_fn"], to_model_space, imgs,
                        batch_size, odin_t, odin_e)
                    cols = metric_names + ("odin", "mahalanobis")
                with profiling.span("sweep.stats"), torch.no_grad():
                    acc, errors, aucs = _error_aurocs(logits, y, metric_names)
                    if uq_extras is not None:
                        aucs += [auroc(od, errors), auroc(_maha.score(state, feats), errors)]
                    aucs_np = (profiling.host_read(torch.stack(aucs), "sweep.aurocs").numpy()
                               if aucs else np.zeros(0, np.float32))
                    out[name][sev] = {
                        "accuracy": float(profiling.host_read(acc, "sweep.accuracy")),
                        "auroc": {m: float(a) for m, a in zip(cols, aucs_np)}}
    return out


def analyze_uncertainty_thresholds(
    metrics: dict[str, torch.Tensor], correct: torch.Tensor
) -> dict[str, dict]:
    """Optimal threshold by Youden's J and the flagged counts per metric
    (cifar_iterative_mc.py:174-219, roc_curve -> argmax(tpr - fpr)); the
    targets are the misclassifications. A confidence metric is negated for
    the search and its threshold reported in its own sign."""
    out = {}
    with torch.no_grad():
        errors = 1.0 - correct.to(torch.float32)
        for name, score in metrics.items():
            sign = -1.0 if name in um.CONFIDENCE_METRICS else 1.0
            s = -score if sign < 0 else score
            t = youden_threshold(s, errors)
            flagged = (s > t).to(torch.float32)
            n_flag = torch.sum(flagged)
            out[name] = {
                "threshold": float(t * sign),
                "auroc": float(auroc(s, errors)),
                "n_flagged": int(n_flag),
                "flagged_error_rate": float(torch.sum(errors * flagged)
                                            / torch.clamp(n_flag, min=1.0)),
            }
    return out
