"""Host-side Gaussian constants (cv2.GaussianBlur semantics).

Computed in float64 on the host; the kernels and their plain versions cast
the taps to float32 exactly where they multiply.
"""

from __future__ import annotations

import numpy as np


def cv2_gaussian_ksize(radius: float) -> int:
    """Kernel-size rule of the reference blur: int(6*radius) forced odd, min 3."""
    k = int(radius * 6)
    if k % 2 == 0:
        k += 1
    if k < 3:
        k = 3
    return k


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (sigma > 0): normalized exp(-x^2/2s^2)."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return w / w.sum()
