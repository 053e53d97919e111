"""Paeth 3-shear parameters, and the per-image-angle rotation.

For one angle the angle -> per-row shift math is computed in float64 on the
host and cast to float32, so the shifts are bit-identical to the CPU
oracle's. Per-image angles take device f32 shifts
(``megakernel._traced_params``).
"""

from __future__ import annotations

import math

import numpy as np


def _paeth_params(angle_deg: float) -> tuple[float, float]:
    # negated so a positive angle matches PIL rotate(-angle), the sign
    # convention of the reference's apply_rotation
    t = math.radians(-angle_deg)
    return -math.tan(t / 2.0), math.sin(t)


def _row_shifts(size: int, slope: float, center: float) -> np.ndarray:
    y = np.arange(size, dtype=np.float64) + 0.5
    return (slope * (y - center)).astype(np.float32)


def rotate_3shear_batched(img, angles_deg, fill: int = 0, max_angle_deg: float = 45.0):
    """One rotation angle an image by three shears with the reference's
    per-pass u8 trunc (oracle fast_warp.rotate_3shear), on the tensor's
    device. A max |angle| beyond ``max_angle_deg`` raises ValueError.

    Delegates to ``fused_blur_rotate_batched`` at radius 0, strict (which
    checks the budget), as the JAX package's ``rotate_3shear_batched``
    does."""
    # imported here: megakernel imports this module at its top
    from imagetransformations_tpu_torch.ops.hopper.megakernel import fused_blur_rotate_batched

    return fused_blur_rotate_batched(img, 0.0, angles_deg, fill=fill, grayscale_out=False,
                                     stream=False, max_angle_deg=float(max_angle_deg))
