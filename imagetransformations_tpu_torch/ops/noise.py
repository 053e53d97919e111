"""Gaussian noise injection (PyTorch).

Counterpart of ``imagetransformations_tpu/ops/noise.py``
``apply_gaussian_noise`` (XLA in the JAX package). The noise comes from a
``torch.Generator``, or is passed in as a standard-normal array so that a
test can feed both packages the same draw.
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.core.image import as_batch, as_float, finalize, restore_layout


def apply_gaussian_noise(img: torch.Tensor, std, generator: torch.Generator | None = None,
                         noise=None) -> torch.Tensor:
    """px_f32 + N(0, std*255), then trunc and clip to [0, 255]
    (transformation.py:272-281). ``std`` is on the [0, 1] scale (grid
    0..0.1), a scalar or one value an image."""
    x, single = as_batch(img)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    else:
        noise, _ = as_batch(torch.as_tensor(noise, dtype=torch.float32, device=x.device))
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    if std.ndim == 0:
        std = std.expand(x.shape[0])
    out = as_float(x) + noise * (std.reshape(-1, 1, 1, 1) * 255.0)
    return restore_layout(finalize(out, img.dtype, "trunc"), single)
