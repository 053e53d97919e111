"""Declarative op-chains on NHWC uint8 batches (PyTorch).

A chain is a list of ``OpSpec`` (name + params), as in the JAX package's
``pipeline/chain.py``. ``build_chain_fn`` routes each blur / rotation /
blur -> rotation prefix, with or without a grayscale after it, to the fused
kernels in stream mode (f32 intermediates, one final quantization) — the
same routing as the JAX ``_match_mega``: a static angle to
``fused_blur_rotate_image``, a concrete angle array (one angle an image)
to ``fused_blur_rotate_batched`` with a budget rounded up to 5 degrees.

Everything else the JAX chain can run is not ported yet and raises
``NotImplementedError`` naming the ROADMAP item that will port it; the
port never falls back to another implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.ops.hopper.megakernel import (
    fused_blur_rotate_batched,
    fused_blur_rotate_image,
)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One stage of a transform chain: op name + params."""

    name: str
    params: dict[str, Any] = dataclasses.field(default_factory=dict)


Chain = Sequence[OpSpec]


def _static(v) -> bool:
    return isinstance(v, (int, float))


def _max_abs_angle(v):
    """max |angle| of a concrete angle array (numpy scalars and tensors
    included) when it is <= 45, else None."""
    if _static(v):
        return None
    try:
        arr = torch.as_tensor(v, dtype=torch.float32)
    except (TypeError, ValueError, RuntimeError):
        return None
    amax = float(arr.abs().max()) if arr.numel() else None
    return amax if amax is not None and amax <= 45.0 else None


def _round_budget(max_abs_deg: float) -> float:
    """Routing budget rounded up to 5-degree steps, as the JAX package's
    (one compiled kernel a budget there; here it bounds the angle check)."""
    return min(45.0, 5.0 * float(np.ceil(max_abs_deg / 5.0))) or 5.0


def _match_mega(chain: list[OpSpec], i: int, channels: int):
    """Match a blur / rotation / blur -> rotation prefix at ``i``,
    optionally followed by grayscale (3 channels only).

    Returns (radius, angle or angle array, grayscale_out, ops_consumed,
    bound) or None; ``bound`` is None for a static angle and the rounded
    budget for an angle array."""
    radius, angle, bound = 0.0, 0.0, None
    j = i
    if chain[j].name == "blur" and _static(chain[j].params["radius"]):
        radius = float(chain[j].params["radius"])
        j += 1
    if j < len(chain) and chain[j].name == "rotation":
        a = chain[j].params["angle"]
        amax = _max_abs_angle(a)
        if _static(a) and abs(float(a)) <= 45.0:
            angle = float(a)
            j += 1
        elif amax is not None:
            angle, bound = a, _round_budget(amax)
            j += 1
    if j == i:
        return None
    gray = j < len(chain) and chain[j].name == "grayscale" and channels == 3
    if gray:
        j += 1
    return radius, angle, gray, j - i, bound


def _not_ported(spec: OpSpec) -> NotImplementedError:
    if spec.name == "rotation":
        return NotImplementedError(
            "rotation with |angle| > 45 runs the affine warp, not ported yet (ROADMAP A.6)"
        )
    return NotImplementedError(
        f"op {spec.name!r} outside a fused blur/rotation segment is not ported yet "
        "(ROADMAP A.6)"
    )


def _plan(chain: list[OpSpec], channels: int) -> list[tuple]:
    """The chain as fused segments (radius, angle, grayscale_out, bound);
    raises for any op no segment takes."""
    segments, i = [], 0
    while i < len(chain):
        mega = _match_mega(chain, i, channels)
        if mega is None:
            raise _not_ported(chain[i])
        radius, angle, gray, consumed, bound = mega
        segments.append((radius, angle, gray, bound))
        i += consumed
    return segments


def _fast_compile_spec(chain: list[OpSpec]):
    """(radius, angle, grayscale_out) when the WHOLE chain is blur ->
    rotation(static, nonzero, |a| <= 45) [-> grayscale], the shape the JAX
    package's ``fast_compile`` sends to its per-image-angle kernel; else
    None. A strict subset of ``_match_mega``'s static-angle matching."""
    i, radius = 0, 0.0
    if i < len(chain) and chain[i].name == "blur" and _static(chain[i].params.get("radius")):
        radius = float(chain[i].params["radius"])
        i += 1
    if i >= len(chain) or chain[i].name != "rotation":
        return None
    a = chain[i].params.get("angle")
    if not _static(a) or float(a) == 0.0 or abs(float(a)) > 45.0:
        return None
    i += 1
    gray = i < len(chain) and chain[i].name == "grayscale"
    if gray:
        i += 1
    return (radius, float(a), gray) if i == len(chain) else None


def build_chain_fn(
    chain: Chain,
    *,
    strict_parity: bool = False,
    fast_compile: bool = False,
    device: str | torch.device | None = None,
) -> Callable[[np.ndarray | torch.Tensor], torch.Tensor]:
    """Compile a chain into ``fn(images) -> images`` (NHWC uint8).

    ``fn`` takes a numpy array or a tensor, moves it to ``device`` and
    returns a tensor there. ``device=None`` means ``"cuda"``: without a GPU
    this raises instead of running on the CPU. ``device="cpu"`` runs the
    kernels' plain PyTorch versions (how the tests run it).

    ``fast_compile=True`` keeps the JAX package's routing: a WHOLE chain
    blur -> rotation(static, nonzero) [-> grayscale] runs the per-image-
    angle kernels with the angle repeated per image (device f32 shifts:
    <= 1 LSB from the static route). Nothing here is compiled per angle,
    so the flag buys no time on the GPU; it exists so that a chain gives
    the same output in both packages.
    """
    if strict_parity:
        raise NotImplementedError(
            "strict_parity=True applies each op on its own; not ported yet (ROADMAP A.6)"
        )
    dev = entry_device(device, "build_chain_fn")
    chain = list(chain)
    _plan(chain, 3)  # raise now for ops no segment can take

    def fn(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = to_device(images, dev)
        if chain and (x.ndim != 4 or x.dtype != torch.uint8):
            raise NotImplementedError(
                "only NHWC uint8 batches are ported; HWC and float inputs "
                "take other ops in the JAX package (ROADMAP A.6)"
            )
        for radius, angle, gray, bound in _plan(chain, x.shape[3] if x.ndim == 4 else 0):
            if bound is None:
                x = fused_blur_rotate_image(x, radius, angle, grayscale_out=gray, stream=True)
            else:
                x = fused_blur_rotate_batched(x, radius, angle, grayscale_out=gray,
                                              stream=True, max_angle_deg=bound)
        return x

    fc = _fast_compile_spec(chain) if fast_compile else None
    if fc is None:
        return fn
    radius_fc, angle_fc, gray_fc = fc

    def fc_fn(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = to_device(images, dev)
        if x.ndim == 4 and x.dtype == torch.uint8 and (not gray_fc or x.shape[3] == 3):
            angles = torch.full((x.shape[0],), angle_fc, dtype=torch.float32, device=dev)
            return fused_blur_rotate_batched(x, radius_fc, angles, grayscale_out=gray_fc, stream=True,
                                             max_angle_deg=_round_budget(abs(angle_fc)))
        return fn(x)  # inputs the kernel does not take: the normal build

    return fc_fn
