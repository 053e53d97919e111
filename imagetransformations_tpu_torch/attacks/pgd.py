"""PGD attack: random start, alpha steps, projection on the eps-ball
(PyTorch).

Counterpart of ``imagetransformations_tpu/attacks/pgd.py:22-50``, after
attacks/fgsm/cifar-10/pgd_cifar10.py:23-47: a uniform start in the
eps-ball, steps of alpha * sign(grad), projection back to the ball, a clip
to the valid range. The JAX ``fori_loop`` is a loop of ``steps`` input
gradients (``attacks.fgsm._ce_grad``: true f32, forward and backward).
"""

from __future__ import annotations

from typing import Callable

import torch

from imagetransformations_tpu_torch.attacks.fgsm import _ce_grad


def pgd_attack(
    model_fn: Callable,
    x: torch.Tensor,
    labels: torch.Tensor,
    generator: torch.Generator | None = None,
    eps: float = 0.03,
    alpha: float = 2.0 / 255,
    steps: int = 10,
    random_start: bool = True,
    clip_min: float = 0.0,
    clip_max: float = 1.0,
    start: torch.Tensor | None = None,
) -> torch.Tensor:
    """The PGD adversary of ``x``. With ``random_start`` the walk starts at
    clip(x + u), u the uniform draw in [-eps, eps] shaped as ``x``:
    ``start`` where given, else drawn from ``generator``."""
    x = x.detach()
    if random_start:
        if start is None:
            start = torch.rand(x.shape, generator=generator, device=x.device) * (2 * eps) - eps
        x_adv = torch.clamp(x + start, clip_min, clip_max)
    else:
        x_adv = x
    lo, hi = x - eps, x + eps
    for _ in range(steps):
        g = _ce_grad(model_fn, x_adv, labels)
        x_adv = torch.clamp(x_adv + alpha * torch.sign(g), lo, hi)  # the eps-ball
        x_adv = torch.clamp(x_adv, clip_min, clip_max)
    return x_adv
