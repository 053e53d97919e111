"""The corruption dispatch of the evaluation harness (PyTorch).

Counterpart of ``imagetransformations_tpu/evalx/harness.py:38-163``:
``CORRUPTIONS`` (the reference's 15 canonical CIFAR-10-C corruptions,
attacks/uncertainty/FINAL_cifar_corrupted.py:22-27, in its order),
``EXTRA_CORRUPTIONS`` (the store's four more, and the sweep-only
rotation and translation) and ``corrupt``, with the JAX package's names,
order and severity values. Every corruption is generated on the device
(``ops.corruptions``); ``rotation`` on a u8 batch on the card runs the
hand-written NEAREST rotation kernel (``csrc/rotate_nearest.cu``).

Not ported yet (ROADMAP A.6): ``corruption_sweep``, the uncertainty
metrics, ``evaluate_batched``, ``analyze_uncertainty_thresholds`` and the
forward caches; they need the port's models (A.4) and uncertainty
modules (A.5).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from imagetransformations_tpu_torch.ops import corruptions as cr
from imagetransformations_tpu_torch.ops import noise as nz
from imagetransformations_tpu_torch.ops import warp as wp


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
