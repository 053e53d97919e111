"""AugMix: a Dirichlet mixture of random op chains, blended with the input
by a Beta weight (PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/augmix.py``
(fall_2025/AugMix.py:30-63): width 3 chains of depth 1-3 over 8 PIL-style
ops (rotation by +-15 degrees, posterize, solarize, equalize, shear,
translations in x and y), Dirichlet(alpha) chain weights, a Beta(alpha,
alpha) blend; one draw for the whole batch.

The rotations are Pillow's NEAREST rotation (``ops.warp.apply_rotation``
on u8, the hand-written ``rotate_nearest`` kernel on the card); the JAX
package's f32 NEAREST rotation is not Pillow's, so a chain with a rotation
differs from JAX's on a few pixels (its own test budget). The shear is the
NEAREST ``affine_warp`` with JAX's matrix, the equalization
``equalize_channel`` over JAX's (n, h, w*c) reshape of the batch.

The draws are the Dirichlet weights ``ws`` [width], the Beta value ``m``,
each chain's depth ``depth_draw`` [width] in 1..max_depth and its ops
``op_draw`` [width, max_depth] in 0..7: pass them (``draws``), or a
``torch.Generator`` from which ``augmix_draws`` makes them on the host.
JAX's ``lax.switch`` / ``where`` over every op is a compile device: here
each chain applies op ``op_draw[i, d]`` where ``d < depth_draw[i]``.
"""

from __future__ import annotations

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.ops import histogram as hg
from imagetransformations_tpu_torch.ops import warp as wp

F32 = torch.float32
N_OPS = 8


def posterize(x: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Keep the top ``bits`` bits of each u8 value."""
    return x & (0xFF & ~((1 << (8 - bits)) - 1))


def solarize(x: torch.Tensor, threshold: float = 128.0) -> torch.Tensor:
    """255 - v for every value >= ``threshold``."""
    xf = x.to(F32)
    return torch.where(xf >= threshold, 255.0 - xf, xf).to(torch.uint8)


def _ops(x: torch.Tensor) -> list:
    """The 8 AugMix ops on an [n, h, w, c] u8 batch, as severity-3-ish
    batched transforms (JAX ``_ops_list``)."""
    n, h, w, c = x.shape
    shear = torch.tensor([1.0, 0.2, -0.2 * h / 2, 0.0, 1.0, 0.0], dtype=F32)
    return [
        lambda v: wp.apply_rotation(v, 15.0),
        lambda v: wp.apply_rotation(v, -15.0),
        lambda v: posterize(v, 4),
        lambda v: solarize(v, 128.0),
        lambda v: hg.equalize_channel(v.reshape(n, h, w * c)).reshape(v.shape),
        lambda v: wp.affine_warp(v, shear, method="nearest"),
        lambda v: wp.apply_translation(v, float(int(w * 0.1)), 0.0),
        lambda v: wp.apply_translation(v, 0.0, float(int(h * 0.1))),
    ]


def augmix_draws(rng: np.random.Generator, width: int = 3, max_depth: int = 3,
                 alpha: float = 1.0) -> dict:
    """One AugMix draw with numpy: ``ws`` Dirichlet(alpha, ..., alpha)
    [width], ``m`` Beta(alpha, alpha), ``depth_draw`` [width] in
    1..max_depth, ``op_draw`` [width, max_depth] in 0..7."""
    return {"ws": rng.dirichlet(np.full(width, alpha)).astype(np.float32),
            "m": np.float32(rng.beta(alpha, alpha)),
            "depth_draw": rng.integers(1, max_depth + 1, width),
            "op_draw": rng.integers(0, N_OPS, (width, max_depth))}


def augmix(
    images,
    generator: torch.Generator | None = None,
    width: int = 3,
    max_depth: int = 3,
    alpha: float = 1.0,
    draws: dict | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """AugMix a u8 NHWC batch (one chain draw for the whole batch):
    ``clip(rint((1 - m) x + m sum_i ws_i chain_i(x)))`` in f32. ``draws``
    as ``augmix_draws`` returns them; without them a seed drawn from
    ``generator`` seeds ``augmix_draws``. Runs on ``device`` (None means
    "cuda", which raises without a GPU)."""
    x = to_device(images, entry_device(device, "augmix"))
    if draws is None:
        if generator is None:
            raise ValueError("augmix draws its chains: pass generator= or draws=")
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
        draws = augmix_draws(np.random.default_rng(seed), width, max_depth, alpha)
    ws = torch.tensor(np.asarray(draws["ws"], np.float32)).to(x.device)
    m = torch.tensor(np.asarray(draws["m"], np.float32)).to(x.device)
    depth = np.asarray(draws["depth_draw"]).reshape(-1)
    op = np.asarray(draws["op_draw"]).reshape(len(depth), -1)
    ops = _ops(x)
    xf = x.to(F32)
    mix = torch.zeros_like(xf)
    for i in range(len(depth)):
        chain = x
        for d in range(int(depth[i])):
            chain = ops[int(op[i, d])](chain)
        mix = mix + ws[i] * chain.to(F32)
    out = (1.0 - m) * xf + m * mix
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
