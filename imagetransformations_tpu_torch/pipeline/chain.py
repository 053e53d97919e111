"""Declarative op-chains on NHWC uint8 batches (PyTorch).

A chain is a list of ``OpSpec`` (name + params), as in the JAX package's
``pipeline/chain.py``. ``build_chain_fn`` routes each static-angle
blur / rotation / blur -> rotation prefix, with or without a grayscale
after it, to the fused kernel ``fused_blur_rotate_image`` in stream mode
(f32 intermediates, one final quantization) — the same routing as the JAX
``_match_mega`` for a static angle.

Everything else the JAX chain can run is not ported yet and raises
``NotImplementedError`` naming the ROADMAP item that will port it; the
port never falls back to another implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from imagetransformations_tpu_torch.ops.hopper.megakernel import fused_blur_rotate_image


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One stage of a transform chain: op name + params."""

    name: str
    params: dict[str, Any] = dataclasses.field(default_factory=dict)


Chain = Sequence[OpSpec]


def _static(v) -> bool:
    return isinstance(v, (int, float))


def _match_mega(chain: list[OpSpec], i: int, channels: int):
    """Match a blur / static rotation / blur -> rotation prefix at ``i``,
    optionally followed by grayscale (3 channels only).

    Returns (radius, angle, grayscale_out, ops_consumed) or None."""
    radius, angle = 0.0, 0.0
    j = i
    if chain[j].name == "blur" and _static(chain[j].params["radius"]):
        radius = float(chain[j].params["radius"])
        j += 1
    if j < len(chain) and chain[j].name == "rotation":
        a = chain[j].params["angle"]
        if _static(a) and abs(float(a)) <= 45.0:
            angle = float(a)
            j += 1
    if j == i:
        return None
    gray = j < len(chain) and chain[j].name == "grayscale" and channels == 3
    if gray:
        j += 1
    return radius, angle, gray, j - i


def _not_ported(spec: OpSpec) -> NotImplementedError:
    if spec.name == "rotation" and not _static(spec.params.get("angle")):
        return NotImplementedError(
            "per-image or traced rotation angles are not ported yet (ROADMAP A.4)"
        )
    if spec.name == "rotation":
        return NotImplementedError(
            "rotation with |angle| > 45 runs the affine warp, not ported yet (ROADMAP A.6)"
        )
    return NotImplementedError(
        f"op {spec.name!r} outside a fused blur/rotation segment is not ported yet "
        "(ROADMAP A.6)"
    )


def _plan(chain: list[OpSpec], channels: int) -> list[tuple[float, float, bool]]:
    """The chain as fused segments (radius, angle, grayscale_out); raises for
    any op no segment takes."""
    segments, i = [], 0
    while i < len(chain):
        mega = _match_mega(chain, i, channels)
        if mega is None:
            raise _not_ported(chain[i])
        radius, angle, gray, consumed = mega
        segments.append((radius, angle, gray))
        i += consumed
    return segments


def build_chain_fn(
    chain: Chain,
    *,
    strict_parity: bool = False,
    device: str | torch.device | None = None,
) -> Callable[[np.ndarray | torch.Tensor], torch.Tensor]:
    """Compile a chain into ``fn(images) -> images`` (NHWC uint8).

    ``fn`` takes a numpy array or a tensor, moves it to ``device`` and
    returns a tensor there. ``device=None`` means ``"cuda"``: without a GPU
    this raises instead of running on the CPU. ``device="cpu"`` runs the
    kernels' plain PyTorch versions (how the tests run it).
    """
    if strict_parity:
        raise NotImplementedError(
            "strict_parity=True applies each op on its own; not ported yet (ROADMAP A.6)"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_chain_fn runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    chain = list(chain)
    _plan(chain, 3)  # raise now for ops no segment can take

    def fn(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(images)
        )
        x = x.to(dev)
        if chain and (x.ndim != 4 or x.dtype != torch.uint8):
            raise NotImplementedError(
                "only NHWC uint8 batches are ported; HWC and float inputs "
                "take other ops in the JAX package (ROADMAP A.6)"
            )
        for radius, angle, gray in _plan(chain, x.shape[3] if x.ndim == 4 else 0):
            x = fused_blur_rotate_image(x, radius, angle, grayscale_out=gray, stream=True)
        return x

    return fn
