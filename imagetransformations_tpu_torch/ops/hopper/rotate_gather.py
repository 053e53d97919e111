"""PIL-exact NEAREST rotation with one angle an image (PyTorch + CUDA).

Counterpart of ``imagetransformations_tpu/ops/pallas/rotate_gather.py``
``pil_rotate_nearest_batched``: the reference's apply_rotation, PIL
``rotate(-angle)`` NEAREST with black fill (transformation.py:198-201), as
``out[y, x] = in[floor(yy), floor(xx)]`` with the f32 inverse-map matrix
``rotation_matrix(angle)``. On the card the hand-written kernel
``csrc/rotate_nearest.cu`` gathers directly; the Pallas kernel's two-pass
roll routing and its host-side proof (``_budgets``, ``_host_bounds_check``)
exist only because Mosaic has no vector gather, and are not ported.

Beside the wrapper sits its plain PyTorch version, which repeats the
kernel's f32 arithmetic op for op. A CPU tensor runs the plain version, a
CUDA tensor the kernel (or the call raises); nothing falls back.
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.ops.hopper import _lib


def rotate_source(mats: torch.Tensor, h: int, w: int):
    """Source pixel of every output pixel: (xx, yy) f32 [n, h, w], floored,
    from ``(m0*xc + m1*yc) + m2`` and ``(m3*xc + m4*yc) + m5`` (every op
    rounded on its own), and the bool [n, h, w] mask of those inside the
    image."""
    m = mats.reshape(-1, 6, 1, 1)
    xc = torch.arange(w, dtype=torch.float32, device=mats.device).view(1, 1, w) + 0.5
    yc = torch.arange(h, dtype=torch.float32, device=mats.device).view(1, h, 1) + 0.5
    xx = torch.floor((m[:, 0] * xc + m[:, 1] * yc) + m[:, 2])
    yy = torch.floor((m[:, 3] * xc + m[:, 4] * yc) + m[:, 5])
    return xx, yy, (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)


def pil_rotate_nearest_plain(x: torch.Tensor, mats: torch.Tensor, fill: int) -> torch.Tensor:
    """Plain version of ``pil_rotate_nearest``: NHWC u8, f32 matrices [n, 6]."""
    n, h, w, c = x.shape
    xx, yy, valid = rotate_source(mats, h, w)
    xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
    yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
    out = x[torch.arange(n, device=x.device).view(n, 1, 1), yi, xi]
    return torch.where(valid[..., None], out, torch.tensor(fill, dtype=torch.uint8,
                                                           device=x.device))


def pil_rotate_nearest(x: torch.Tensor, mats: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """NHWC u8 -> NHWC u8, one f32 inverse-map matrix [6] an image.

    On CUDA: ``csrc/rotate_nearest.cu``; on the CPU: the plain version."""
    if not 0 <= int(fill) <= 255:
        raise ValueError(f"fill must be a u8 value, got {fill}")
    if x.device.type == "cpu":
        return pil_rotate_nearest_plain(x, mats, int(fill))
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.uint8 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("expected a contiguous NHWC uint8 tensor")
    n, h, w, c = x.shape
    if (mats.device != x.device or mats.dtype != torch.float32
            or mats.shape != (n, 6) or not mats.is_contiguous()):
        raise ValueError("mats must be a contiguous f32 [n, 6] tensor on the image's device")
    if h > 65535:
        raise ValueError("rotate_nearest launches one block row per image row: h <= 65535")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name = "rotate_nearest"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        err = lib.rotate_nearest(x.data_ptr(), out.data_ptr(), mats.data_ptr(), n, h, w, c,
                                 int(fill), torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(name, err)
    _lib.LAUNCHES["pil_rotate_nearest"] += 1
    return out


def pil_rotate_nearest_batched(img: torch.Tensor, angles_deg, fill: int = 0,
                               max_angle_deg: float = 45.0) -> torch.Tensor:
    """PIL-parity NEAREST rotation with one angle an image (or one for the
    batch), on the tensor's device. NHWC u8 -> u8.

    The matrices ``rotation_matrix(angles)`` are computed once, in f32 on
    the images' device, and go to the kernel (or the plain version).
    ``max_angle_deg`` is the JAX signature's routing budget: the direct
    gather needs none and is exact for any angle, so it only documents the
    range the caller promises."""
    # imported here: ops.warp imports this module at its top
    from imagetransformations_tpu_torch.ops.warp import rotation_matrix

    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    del max_angle_deg  # documentation only (see above)
    n, h, w, _ = img.shape
    m = rotation_matrix(angles_deg, w, h, device=img.device)
    return pil_rotate_nearest(img.contiguous(), m.expand(n, 6).contiguous(), fill)
