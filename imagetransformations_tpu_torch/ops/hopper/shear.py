"""Host-side Paeth 3-shear parameters.

The angle -> per-row shift math is computed in float64 on the host and cast
to float32, so the shifts are bit-identical to the CPU oracle's.
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
