"""Declarative op-chains on image batches (PyTorch).

A chain is a list of ``OpSpec`` (name + params), as in the JAX package's
``pipeline/chain.py``, and ``build_chain_fn`` dispatches it as the JAX
function does (chain.py:318-409):

1. **Fused blur / rotation.** On an NHWC uint8 batch (not strict), each
   blur / rotation / blur -> rotation prefix, with or without a grayscale
   after it, runs the fused kernels in stream mode (f32 intermediates, one
   final quantization): a static angle (|a| <= 45) through
   ``fused_blur_rotate_image``, a concrete angle array through
   ``fused_blur_rotate_batched`` with a budget rounded up to 5 degrees.
2. **Affine fusion** (not strict). A run of two or more affine ops
   (rotation, translation, zoom, flip_vertical) becomes one
   ``affine_warp`` of the composed inverse-map matrices. A single rotation
   the kernels did not take (|a| > 45, float images, angle arrays beyond
   45) becomes ``affine_warp(rotation_matrix)``; any other single affine op
   runs its own op.
3. **Blur** (not strict). A static-radius blur of uint8 images the fused
   kernels did not take (HWC input) runs ``blur_separable``.
4. Everything else, and every op with ``strict_parity=True``, runs its own
   op, which quantizes to uint8 as the reference's per-image PIL / OpenCV
   call does.

HWC input goes op by op, as in JAX. Float32 input stays float. The noise
ops draw from the ``generator`` given to the chain function, one draw after
another in chain order (JAX splits one key per op); without a generator
they raise ValueError, as JAX cannot draw without a key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import (
    as_batch,
    entry_device,
    restore_layout,
    to_device,
)
from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import histogram as hg
from imagetransformations_tpu_torch.ops import noise as nz
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops import warp as wp
from imagetransformations_tpu_torch.ops.hopper.blur import blur_separable
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

#: ops expressible as an inverse-map affine matrix (fusable into one warp)
_AFFINE_OPS = {"rotation", "translation", "zoom", "flip_vertical"}
_NOISE_OPS = {"gaussian_noise", "impulse_noise", "shot_noise"}


def _affine_matrix(spec: OpSpec, w: int, h: int, device: torch.device) -> torch.Tensor:
    p = spec.params
    if spec.name == "rotation":
        return wp.rotation_matrix(p["angle"], w, h, device=device)
    if spec.name == "translation":
        return wp.translation_matrix(p["tx"], p.get("ty", p["tx"]), device=device)
    if spec.name == "zoom":
        return wp.zoom_matrix(p["factor"], w, h, device=device)
    if spec.name == "flip_vertical":
        return torch.tensor([[1.0, 0.0, 0.0, 0.0, -1.0, float(h)]], device=device)
    raise ValueError(spec.name)


def _apply_simple(x: torch.Tensor, spec: OpSpec, generator) -> torch.Tensor:
    """One op on its own, with the reference's per-op quantization."""
    p = spec.params
    name = spec.name
    if name in _NOISE_OPS and generator is None:
        raise ValueError(f"op {name!r} draws noise: pass a torch.Generator to the chain")
    if name in ("brightness", "lighten_darken"):
        return ew.apply_brightness(x, p["factor"])
    if name == "contrast":
        return ew.apply_contrast(x, p["alpha"])
    if name == "grayscale":
        return ew.grayscale(x)
    if name == "invert":
        return ew.invert(x)
    if name == "enhance_contrast":
        return ew.enhance_contrast(x, p["factor"])
    if name == "enhance_color":
        return ew.enhance_color(x, p["factor"])
    if name == "sharpness":
        return st.sharpen(x, p["factor"])
    if name == "blur":
        return st.apply_blur(x, p["radius"])
    if name == "motion_blur":
        return st.motion_blur(x, p["ksize"])
    if name == "gaussian_noise":
        return nz.apply_gaussian_noise(x, p["std"], generator=generator)
    if name == "impulse_noise":
        return nz.impulse_noise(x, p["amount"], generator=generator)
    if name == "shot_noise":
        return nz.shot_noise(x, p["lam"], generator=generator)
    if name == "histogram_equalization":
        return hg.histogram_equalization(x)
    if name == "scale":
        return wp.apply_scale(x, p["factor"])
    if name == "shear":
        return wp.apply_shear(x, p["factor"])
    # affine ops on their own: strict mode, or a single op of a run
    if name == "rotation":
        return wp.apply_rotation(x, p["angle"], max_angle_deg=p.get("max_angle_deg"))
    if name == "translation":
        return wp.apply_translation(x, p["tx"], p.get("ty", p["tx"]))
    if name == "zoom":
        return wp.random_zoom(x, p["factor"])
    if name == "flip_vertical":
        return wp.flip_vertical(x)
    raise ValueError(f"unknown op {name!r}")


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
    optionally followed by grayscale (3 channels only). The caller checks
    the JAX function's other guards (not strict, NHWC, uint8).

    Returns (radius, angle or angle array, grayscale_out, ops_consumed,
    bound) or None; ``bound`` is None for a static angle and the rounded
    budget for an angle array: of the spec's ``max_angle_deg`` where it is
    at least the array's max |angle|, else of that max."""
    radius, angle, bound = 0.0, 0.0, None
    j = i
    if chain[j].name == "blur" and _static(chain[j].params["radius"]):
        radius = float(chain[j].params["radius"])
        j += 1
    if j < len(chain) and chain[j].name == "rotation":
        a = chain[j].params["angle"]
        amax = _max_abs_angle(a)
        hint = chain[j].params.get("max_angle_deg")
        if _static(a) and abs(float(a)) <= 45.0:
            angle = float(a)
            j += 1
        elif amax is not None:
            # a declared budget (``sharded_chain_fn`` passes the global
            # batch's to each shard) is kept where it covers the angles; it
            # clips nothing then and changes no pixel, only the kernels'
            # tile bound on the card
            if hint is not None and amax <= float(hint) <= 45.0:
                amax = float(hint)
            angle, bound = a, _round_budget(amax)
            j += 1
    if j == i:
        return None
    gray = j < len(chain) and chain[j].name == "grayscale" and channels == 3
    if gray:
        j += 1
    return radius, angle, gray, j - i, bound


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


def _run_chain(chain: list[OpSpec], x: torch.Tensor, strict_parity: bool, warp_method: str,
               generator) -> torch.Tensor:
    h, w = (x.shape[1], x.shape[2]) if x.ndim == 4 else (x.shape[0], x.shape[1])
    i = 0
    while i < len(chain):
        spec = chain[i]
        fusable = not strict_parity and x.ndim == 4 and x.dtype == torch.uint8
        mega = _match_mega(chain, i, x.shape[3]) if fusable else None
        if mega is not None:
            radius, angle, gray, consumed, bound = mega
            if bound is None:
                x = fused_blur_rotate_image(x, radius, angle, grayscale_out=gray, stream=True)
            else:
                x = fused_blur_rotate_batched(x, radius, angle, grayscale_out=gray,
                                              stream=True, max_angle_deg=bound)
            i += consumed
        elif not strict_parity and spec.name in _AFFINE_OPS:
            j = i + 1
            while j < len(chain) and chain[j].name in _AFFINE_OPS:
                j += 1
            if j == i + 1 and spec.name != "rotation":
                x = _apply_simple(x, spec, generator)
            else:
                # a run, or a rotation the kernels did not take; warping with
                # m_a then m_b is one warp with compose_matrices(m_b, m_a)
                m = _affine_matrix(spec, w, h, x.device)
                for spec2 in chain[i + 1 : j]:
                    m = wp.compose_matrices(_affine_matrix(spec2, w, h, x.device), m)
                x = wp.affine_warp(x, m, method=warp_method, fill=0.0)
            i = j
        elif (not strict_parity and spec.name == "blur" and _static(spec.params["radius"])
              and x.dtype == torch.uint8):
            # HWC input: the JAX chain hands it to blur_separable as it is and
            # fails unpacking four dims; this blurs it as one image
            xb, single = as_batch(x)
            x = restore_layout(blur_separable(xb, float(spec.params["radius"])), single)
            i += 1
        else:
            x = _apply_simple(x, spec, generator)
            i += 1
    return x


def build_chain_fn(
    chain: Chain,
    *,
    strict_parity: bool = False,
    warp_method: str = "bilinear",
    fast_compile: bool = False,
    jit: bool = True,
    device: str | torch.device | None = None,
) -> Callable[..., torch.Tensor]:
    """Compile a chain into ``fn(images, generator=None) -> images``.

    ``fn`` takes an NHWC or HWC batch, uint8 or float32, as a numpy array or
    a tensor, moves it to ``device`` and returns a tensor there.
    ``device=None`` means ``"cuda"``: without a GPU this raises instead of
    running on the CPU. ``device="cpu"`` runs the kernels' plain PyTorch
    versions (how the tests run it). ``generator`` (a ``torch.Generator`` on
    that device) feeds the noise ops.

    ``strict_parity=True`` applies every op on its own with the reference's
    per-op uint8 quantization; the default fuses as described in the module
    docstring. ``warp_method`` ("nearest", "bilinear", "bicubic") is the
    sampling of the fused affine warps.

    ``fast_compile=True`` keeps the JAX package's routing: a WHOLE chain
    blur -> rotation(static, nonzero) [-> grayscale] runs the per-image-
    angle kernels with the angle repeated per image (device f32 shifts:
    <= 1 LSB from the static route). Nothing here is compiled per angle,
    so the flag buys no time on the GPU; it exists so that a chain gives
    the same output in both packages.

    ``jit`` is the JAX signature's: eager PyTorch has nothing to compile,
    so either value builds the same function. As in JAX, ``fast_compile``
    takes effect only with ``jit=True`` (JAX's ``jit=False`` build is the
    normal one, which the evolutionary search's one-op chains use).
    """
    dev = entry_device(device, "build_chain_fn")
    chain = list(chain)

    def fn(images: np.ndarray | torch.Tensor,
           generator: torch.Generator | None = None) -> torch.Tensor:
        return _run_chain(chain, to_device(images, dev), strict_parity, warp_method, generator)

    fc = _fast_compile_spec(chain) if fast_compile and jit and not strict_parity else None
    if fc is None:
        return fn
    radius_fc, angle_fc, gray_fc = fc

    def fc_fn(images: np.ndarray | torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        x = to_device(images, dev)
        if x.ndim == 4 and x.dtype == torch.uint8 and (not gray_fc or x.shape[3] == 3):
            angles = torch.full((x.shape[0],), angle_fc, dtype=torch.float32, device=dev)
            return fused_blur_rotate_batched(x, radius_fc, angles, grayscale_out=gray_fc, stream=True,
                                             max_angle_deg=_round_budget(abs(angle_fc)))
        return fn(x, generator)  # inputs the kernel does not take: the normal build

    return fc_fn
