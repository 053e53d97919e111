"""Traffic kind ``apply_all_fast``: the reference's 8-type sweep
(transformation.py:92-170) as on-device augmentation at the port's fast
flags, ``apply_all_transformations(x, g, pil_parity_scale_shear=False,
pil_parity_rotation=True)``: the bilinear zoom (#10), Pillow's NEAREST
rotation (#12) and the row-shift shear (#9) beside the five types the
flags leave alone. One call a pass over ``images_per_call`` images; ``g``
a generator on the device seeded from ``--seed``, every call drawing
anew. The window, the sample and the comparison are
``transform_window``'s; the reference (``reference/transforms_fast.py``)
replays the calls' draws from the seed.

``fast_work`` counts the work of a call at these flags, as
``roofline.apply_all_work`` does at the default flags, for
``kernel_roofline_pct`` and ``step_mfu_pct``."""

from __future__ import annotations

import numpy as np
import torch

from harness import apply_all_kind, inputs, transform_window
from reference import transforms as rt
from reference import transforms_fast as rtf
from reference.image import cv2_gaussian_ksize

FLAGS = {"pil_parity_scale_shear": False, "pil_parity_rotation": True}


def _zoom_valid(size: int, factor: float) -> int:
    """Output places along one axis of size ``size`` whose source lies on
    the image at zoom ``factor`` (the rest are filled, with no taps)."""
    inv = 1.0 / factor
    src = inv * (np.arange(size) + 0.5) + (size / 2.0 - inv * size / 2.0)
    return int(np.count_nonzero((src >= 0) & (src < size)))


def fast_work(shape: tuple, values: dict) -> tuple[float, float]:
    """(bytes, flops) of one call at the fast flags on a u8 batch of
    ``shape`` (N, H, W, C) with each type's drawn values ({type: [N]}).
    Bytes: the input once, the 8 outputs and the drawn values. Flops a
    pixel-channel: the zoom 9 (two lerps along x and one along y, 3 ops
    each) on the places that have a source, none at factor 1; the NEAREST
    rotation none (a gather); brightness 1; noise 2; translation 0;
    contrast 1; blur cv2's separable Gaussian (2 passes of ksize taps, 2 a
    tap, none at radius 0); the shear one lerp (3), none at factor 0."""
    n, h, w, c = shape
    px = h * w * c
    types = len(rt.TYPES)
    nbytes = n * px + types * n * px + types * n * 4
    v = {t: np.asarray(values[t], np.float64) for t in rt.TYPES}
    zoom = sum(9.0 * c * _zoom_valid(h, float(f)) * _zoom_valid(w, float(f))
               for f in np.asarray(values["scale"], np.float32) if f != 1.0)
    blur = sum(4.0 * cv2_gaussian_ksize(float(r)) * px for r in v["blur"] if r > 0)
    flops = zoom + (1.0 + 2.0 + 1.0) * n * px + blur + 3.0 * px * np.count_nonzero(v["shear"])
    return float(nbytes), float(flops)


class Entry(apply_all_kind.Entry):
    """``apply_all_kind``'s call at the fast flags, with their work and
    their reference."""

    def __init__(self, r, x: torch.Tensor):
        super().__init__(r, x)
        from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations

        self.port = lambda xb, g: apply_all_transformations(xb, g, device=r.device, **FLAGS)

    def work(self, i: int, drawn) -> tuple[float, float]:
        return fast_work(tuple(self.batch(i).shape),
                         {t: v.cpu().numpy() for t, v in drawn.items()})

    def reference(self, picked: list, dtype=torch.float32) -> dict:
        out = {}
        g = inputs.generator(self.r.seed, self.r.device, "calls")
        for i in range(max(picked) + 1):
            d = rt.sweep_draws(g, tuple(self.batch(i).shape))
            if i in picked:
                out[i] = rtf.apply_all_fast(self.batch(i), d, dtype)
        return out


def run(r) -> dict:
    return transform_window.run(r, Entry)


def control(r, done: int):
    return transform_window.control(r, Entry, done)
