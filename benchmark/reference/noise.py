"""Frozen copy of the port's ``ops/noise.py`` (the benchmark's reference).
Its original docstring follows.

Noise injection: Gaussian, impulse (salt and pepper) and shot noise
(PyTorch).

Counterpart of ``imagetransformations_tpu/ops/noise.py`` (XLA in the JAX
package). The randomness comes from an explicit ``torch.Generator`` (the
JAX package threads ``jax.random`` keys; the two give different numbers
from one seed), or is passed in (``noise=``, ``u=``) so that a test can feed
both packages the same draw.
"""

from __future__ import annotations

import torch

from .image import as_batch, as_float, finalize, restore_layout


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


def gaussian_noise_01(img: torch.Tensor, severity_std, generator: torch.Generator | None = None,
                      noise=None) -> torch.Tensor:
    """The TransformationPool's Gaussian noise on the [0, 1] scale:
    ``clip(x/255 + N(0, s), 0, 1) * 255``, rint for u8
    (pipenline/cifar_image_transformations.py:39-47; severities .08-.38,
    CIFAR-10-C's .04-.10). ``noise``: a standard-normal draw of the image's
    shape, drawn from ``generator`` when not given; ``severity_std`` a
    scalar or one value an image. The division by 255 is a true division
    on every device (a tensor divisor: PyTorch's CUDA kernel multiplies by
    the reciprocal of a Python-number divisor)."""
    x, single = as_batch(img)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    else:
        noise, _ = as_batch(torch.as_tensor(noise, dtype=torch.float32, device=x.device))
    s = torch.as_tensor(severity_std, dtype=torch.float32, device=x.device)
    if s.ndim == 0:
        s = s.expand(x.shape[0])
    x01 = as_float(x) / torch.tensor(255.0, device=x.device)
    out = torch.clamp(x01 + noise * s.reshape(-1, 1, 1, 1), 0.0, 1.0) * 255.0
    return restore_layout(finalize(out, img.dtype, "rint"), single)


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


def shot_noise(img: torch.Tensor, lam, generator: torch.Generator | None = None,
               draw=None) -> torch.Tensor:
    """Poisson shot noise ``Poisson(x/255 * lam) / lam``, clipped to [0, 1]
    and scaled back by 255, rint for u8 (pipenline/
    cifar_image_transformations.py:60-70; lam 60..3, smaller is more
    severe). ``lam`` is a scalar or one value an image. ``draw``: the
    Poisson counts, one a value of the image (the JAX op has no such
    keyword; it lets a caller hold two devices to one draw), drawn from
    ``generator`` when not given."""
    x, single = as_batch(img)
    lam_v = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    if lam_v.ndim == 0:
        lam_v = lam_v.expand(x.shape[0])
    lam_v = lam_v.reshape(-1, 1, 1, 1)
    if draw is None:
        rate = as_float(x) / 255.0 * lam_v
        draw = torch.poisson(rate, generator=generator)
    else:
        draw, _ = as_batch(torch.as_tensor(draw, dtype=torch.float32, device=x.device))
    out = torch.clamp(draw / lam_v, 0.0, 1.0) * 255.0
    return restore_layout(finalize(out, img.dtype, "rint"), single)
