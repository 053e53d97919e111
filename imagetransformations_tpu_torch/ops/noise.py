"""Noise injection: Gaussian, impulse (salt and pepper) and shot noise
(PyTorch).

Counterpart of ``imagetransformations_tpu/ops/noise.py`` (XLA in the JAX
package). The randomness comes from an explicit ``torch.Generator`` (the
JAX package threads ``jax.random`` keys; the two give different numbers
from one seed), or is passed in (``noise=``, ``u=``) so that a test can feed
both packages the same draw.
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


def impulse_noise(img: torch.Tensor, amount, generator: torch.Generator | None = None,
                  u=None) -> torch.Tensor:
    """Salt and pepper over a fraction ``amount`` of the pixels, all
    channels together: 255 where ``u < a/2``, 0 where ``a/2 <= u < a``
    (pipenline/cifar_image_transformations.py:49-58). ``u`` is one uniform
    [0, 1) draw a pixel ([N, H, W] or [H, W]), drawn from ``generator``
    when not given; ``amount`` a scalar or one value an image."""
    x, single = as_batch(img)
    if u is None:
        u = torch.rand(x.shape[:-1], generator=generator, device=x.device, dtype=torch.float32)
    else:
        u = torch.as_tensor(u, dtype=torch.float32, device=x.device)
        if u.ndim == 2:
            u = u[None]
    a = torch.as_tensor(amount, dtype=torch.float32, device=x.device)
    if a.ndim == 0:
        a = a.expand(x.shape[0])
    a = a.reshape(-1, 1, 1)
    salt = (u < a / 2)[..., None]
    pepper = ((u >= a / 2) & (u < a))[..., None]
    out = torch.where(salt, 255.0, torch.where(pepper, 0.0, as_float(x)))
    return restore_layout(finalize(out, img.dtype, "rint"), single)


def shot_noise(img: torch.Tensor, lam, generator: torch.Generator | None = None) -> torch.Tensor:
    """Poisson shot noise ``Poisson(x/255 * lam) / lam``, clipped to [0, 1]
    and scaled back by 255, rint for u8 (pipenline/
    cifar_image_transformations.py:60-70; lam 60..3, smaller is more
    severe). ``lam`` is a scalar or one value an image."""
    x, single = as_batch(img)
    lam_v = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    if lam_v.ndim == 0:
        lam_v = lam_v.expand(x.shape[0])
    lam_v = lam_v.reshape(-1, 1, 1, 1)
    rate = as_float(x) / 255.0 * lam_v
    draw = torch.poisson(rate, generator=generator)
    out = torch.clamp(draw / lam_v, 0.0, 1.0) * 255.0
    return restore_layout(finalize(out, img.dtype, "rint"), single)
