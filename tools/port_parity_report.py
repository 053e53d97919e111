#!/usr/bin/env python3
"""How far the PyTorch port sits from the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/port_parity_report.py

Prints one JSON line per gate of the port's warp, fast-sweep, blur, row
shift, op and chain tests (tests/test_torch_warp.py,
tests/test_torch_apply_all_fast.py, tests/test_torch_blur.py,
tests/test_torch_shear.py, tests/test_torch_ops.py,
tests/test_torch_chain_full.py), on the same inputs: the largest difference
in LSB and the share of values (or, for NEAREST rotation, of pixels) that
differ, against the JAX function (Pallas in interpret mode) and the numpy
oracle. The tests assert the budgets; this prints the measured values. Runs
in about two minutes.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from imagetransformations_tpu.core.grids import PARAM_GRIDS  # noqa: E402
from imagetransformations_tpu.oracle import warp as oww  # noqa: E402
from imagetransformations_tpu.ops import warp as jwp  # noqa: E402
from imagetransformations_tpu.ops.pallas import resample as jrs  # noqa: E402
from imagetransformations_tpu.ops.pallas import rotate_gather as jrg  # noqa: E402
from imagetransformations_tpu.pipeline import batch as jbatch  # noqa: E402
from imagetransformations_tpu.pipeline import chain as jchain  # noqa: E402
from imagetransformations_tpu import ops as jops  # noqa: E402
from imagetransformations_tpu.oracle import elementwise as oe  # noqa: E402
from imagetransformations_tpu.oracle import fast_warp as ofw  # noqa: E402
from imagetransformations_tpu.oracle import stencil as ost  # noqa: E402
from imagetransformations_tpu.ops import stencil as jst  # noqa: E402
from imagetransformations_tpu.ops.pallas import blur as jblur  # noqa: E402
from imagetransformations_tpu.ops.pallas import shear as jshear  # noqa: E402

import imagetransformations_tpu_torch as port  # noqa: E402
from imagetransformations_tpu_torch.ops import warp as twp  # noqa: E402
from imagetransformations_tpu_torch.ops.hopper.resample import zoom_bilinear_batched  # noqa: E402
from imagetransformations_tpu_torch.ops.hopper.rotate_gather import (  # noqa: E402
    pil_rotate_nearest_batched,
)
from imagetransformations_tpu_torch.pipeline import batch as tbatch  # noqa: E402
from imagetransformations_tpu_torch.pipeline import chain as tchain  # noqa: E402
from imagetransformations_tpu_torch.ops import elementwise as tew  # noqa: E402
from imagetransformations_tpu_torch.ops import stencil as tst  # noqa: E402
from imagetransformations_tpu_torch.ops.hopper import blur as tblur  # noqa: E402
from imagetransformations_tpu_torch.ops.hopper import shear as tshear  # noqa: E402

ZOOM_FACTORS = np.asarray([*PARAM_GRIDS["scale"].values(), 0.85, 1.45], np.float32)


def values(a, b) -> dict:
    err = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return {"max_lsb": int(err.max()), "frac": float((err > 0).mean())}


def pixels(a, b) -> dict:
    return {"pixel_frac": float((np.asarray(a) != np.asarray(b)).any(-1).mean())}


def emit(gate: str, shape, against: str, **res) -> None:
    print(json.dumps({"gate": gate, "shape": list(shape), "against": against, **res}),
          flush=True)


def ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def main() -> int:
    # matrices: every entry, grid angles and off the grid
    grid = np.asarray([*PARAM_GRIDS["rotation"].values(), 45.0, -45.0], np.float32)
    off = np.asarray([60.0, 90.0, -60.0, 7.3, 137.0], np.float32)
    for w, h in ((32, 32), (53, 37), (48, 64), (512, 512)):
        for name, a in (("grid", grid), ("off_grid", off)):
            emit("rotation_matrix", (h, w), f"jax ({name} angles)",
                 max_ulp=ulps(twp.rotation_matrix(a, w, h), jwp.rotation_matrix(a, w, h)))
    f = np.asarray([*ZOOM_FACTORS, 0.5, 4.0, 0.3], np.float32)
    emit("zoom_matrix", (37, 53), "jax",
         max_ulp=ulps(twp.zoom_matrix(f, 53, 37), jwp.zoom_matrix(f, 53, 37)))

    # zoom (kernel #10): the scale grid and the budget bounds
    for shape in ((8, 64, 48, 3), (8, 32, 32, 3), (8, 37, 53, 3)):
        imgs = np.random.default_rng(1234).integers(0, 256, shape, dtype=np.uint8)
        out = zoom_bilinear_batched(torch.from_numpy(imgs), ZOOM_FACTORS).numpy()
        want = np.asarray(jrs.zoom_bilinear_batched(jnp.asarray(imgs), jnp.asarray(ZOOM_FACTORS)))
        h, w = shape[1:3]
        ref = np.stack([oww.affine_bilinear(imgs[i], np.asarray(jwp.zoom_matrix(float(v), w, h),
                                                                np.float64)[0])
                        for i, v in enumerate(ZOOM_FACTORS)])
        emit("zoom_bilinear", shape, "jax kernel", **values(out, want),
             per_factor=[values(out[i], want[i])["frac"] for i in range(len(ZOOM_FACTORS))])
        emit("zoom_bilinear", shape, "f64 oracle", **values(out, ref))
        emit("zoom_bilinear (jax kernel itself)", shape, "f64 oracle", **values(want, ref))

    # NEAREST rotation (kernel #12): Pillow's fixed point, so 0 pixels
    # differ from PIL; the JAX package's f32 coordinates (its kernel within
    # 45 degrees, apply_rotation's warp beyond) and the f64 oracle differ
    def pil_rotate(im, ang):
        return np.asarray(Image.fromarray(im).rotate(-float(ang), fillcolor=(0, 0, 0)))

    cases = [((4, 32, 32), [-20.0, 0.0, 10.0, 22.5]), ((2, 37, 53), [7.0, -44.0]),
             ((1, 96, 64), [22.5]), ((3, 40, 24), [-7.5, 2.5, 17.5]),
             ((2, 32, 32), [45.0, -45.0])]
    for (n, h, w), angles in cases:
        imgs = np.random.default_rng(1234).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
        a = np.asarray(angles, np.float32)
        out = pil_rotate_nearest_batched(torch.from_numpy(imgs), a).numpy()
        want = np.asarray(jrg.pil_rotate_nearest_batched(jnp.asarray(imgs), jnp.asarray(a)))
        for i, ang in enumerate(a):
            emit("pil_rotate_nearest", (h, w, float(ang)), "PIL / jax kernel / f64 oracle",
                 pil=pixels(out[i], pil_rotate(imgs[i], ang))["pixel_frac"],
                 jax=pixels(out[i], want[i])["pixel_frac"],
                 oracle=pixels(out[i], oww.apply_rotation(imgs[i], float(ang)))["pixel_frac"])
    beyond = [60.0, -60.0, 90.0, 135.0, -135.0, 179.0]
    for h, w in ((32, 32), (23, 37), (17, 5), (48, 64)):
        imgs = np.random.default_rng(1234).integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        for ang in beyond:
            out = port.apply_rotation(torch.from_numpy(imgs), ang).numpy()[0]
            want = np.asarray(jwp.apply_rotation(jnp.asarray(imgs), ang))[0]
            emit("apply_rotation u8 beyond 45", (h, w, ang), "PIL / jax apply_rotation",
                 pil=pixels(out, pil_rotate(imgs[0], ang))["pixel_frac"],
                 jax=pixels(out, want)["pixel_frac"],
                 jax_vs_pil=pixels(want, pil_rotate(imgs[0], ang))["pixel_frac"])

    # the sweep with both non-default flags, as tests/test_torch_apply_all_fast.py runs it
    imgs = np.random.default_rng(7).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    res = port.apply_all_transformations(imgs, 3, device="cpu", pil_parity_scale_shear=False,
                                         pil_parity_rotation=True)
    x = jnp.asarray(imgs)
    v = {t: jnp.asarray(res[t][0].numpy()) for t in ("scale", "shear", "rotation")}
    emit("apply_all fast scale", imgs.shape, "jax _zoom_fast",
         **values(res["scale"][1].numpy(), jbatch._zoom_fast(x, v["scale"])))
    emit("apply_all fast shear", imgs.shape, "jax _shear_fast_batched",
         **values(res["shear"][1].numpy(), jbatch._shear_fast_batched(x, v["shear"], 1.0)))
    want = np.asarray(jrg.pil_rotate_nearest_batched(x, v["rotation"], max_angle_deg=23.0))
    got = res["rotation"][1].numpy()
    emit("apply_all PIL rotation", imgs.shape, "PIL / jax pil_rotate_nearest_batched",
         pil_pixel_frac_max=max(pixels(got[i], pil_rotate(imgs[i], a))["pixel_frac"]
                                for i, a in enumerate(res["rotation"][0].tolist())),
         pixel_frac_max=max(pixels(got[i], want[i])["pixel_frac"] for i in range(len(imgs))))

    # the per-grid-value sweep
    rng = np.random.default_rng(1234)
    imgs = rng.integers(0, 256, (6, 24, 20, 3), dtype=np.uint8)
    vals = np.asarray([0.3, 0.0, 0.7, 0.3, 0.7, 0.0], np.float32)
    out = tbatch._value_sweep_per_value(torch.from_numpy(imgs), torch.from_numpy(vals), "shear",
                                        (0.0, 0.3, 0.7))
    want = jbatch._value_sweep_per_value(jnp.asarray(imgs), jnp.asarray(vals), "shear",
                                         (0.0, 0.3, 0.7))
    emit("_value_sweep_per_value shear", imgs.shape, "jax", **values(out.numpy(), want))
    imgs = np.random.default_rng(1234).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    vals = np.asarray([60.0, -22.5, 15.0, 0.0, 60.0, -22.5], np.float32)
    grid = (-22.5, 0.0, 15.0, 60.0)
    idx = torch.tensor([grid.index(float(v)) for v in vals])
    out = tbatch._rotation_pil(torch.from_numpy(imgs), idx, grid).numpy()
    want = np.asarray(jbatch._value_sweep_per_value(jnp.asarray(imgs), jnp.asarray(vals),
                                                    "rotation_pil", grid))
    emit("PIL rotation, grid beyond 45", imgs.shape, "PIL / jax _value_sweep_per_value",
         pil_pixel_frac_max=max(pixels(out[i], pil_rotate(imgs[i], a))["pixel_frac"]
                                for i, a in enumerate(vals)),
         pixel_frac_max=max(pixels(out[i], want[i])["pixel_frac"] for i in range(len(imgs))))

    # affine_warp against JAX and the f64 oracles
    imgs = np.random.default_rng(1234).integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    mats = {
        "rotation 33": np.asarray(jwp.rotation_matrix(33.0, 53, 37), np.float32)[0],
        "zoom 1.3": np.asarray(jwp.zoom_matrix(1.3, 53, 37), np.float32)[0],
        "shear 0.4": np.asarray(oww.shear_matrix(0.4, 37), np.float32),
    }
    oracles = {"nearest": oww.affine_nearest, "bilinear": oww.affine_bilinear,
               "bicubic": oww.affine_bicubic}
    for method, oracle in oracles.items():
        for name, m in mats.items():
            out = twp.affine_warp(torch.from_numpy(imgs), torch.from_numpy(m),
                                  method=method).numpy()
            want = np.asarray(jwp.affine_warp(jnp.asarray(imgs), jnp.asarray(m), method=method))
            ref = np.stack([oracle(im, m.astype(np.float64)) for im in imgs])
            emit(f"affine_warp {method} {name}", imgs.shape, "jax", **values(out, want))
            emit(f"affine_warp {method} {name}", imgs.shape, "f64 oracle", **values(out, ref))
    blur_and_shears()
    ops_and_chains()
    return 0


def blur_and_shears() -> None:
    """Kernels #6-#8 and the 3-shear rotations (tests/test_torch_blur.py,
    tests/test_torch_shear.py)."""
    for shape in ((2, 48, 40, 3), (2, 40, 48, 3), (2, 64, 128, 3)):
        x = np.random.default_rng(1234).integers(0, 256, shape, dtype=np.uint8)
        for r in (0.5, 1.5, 5.0):
            out = tblur.blur_separable(torch.from_numpy(x), r).numpy()
            want = np.asarray(jblur.blur_separable(jnp.asarray(x), r))
            ref = np.stack([ost.gaussian_blur(im, r) for im in x])
            emit(f"blur_separable r {r}", shape, "jax kernel", **values(out, want))
            emit(f"blur_separable r {r}", shape, "f64 oracle", **values(out, ref))
    rng = np.random.default_rng(1234)
    x = rng.integers(0, 256, (2, 48, 40, 3), dtype=np.uint8)
    s = (rng.random(48).astype(np.float32) - 0.5) * 20.0
    for post in (None, "grayscale"):
        out = tshear.shear_rows(torch.from_numpy(x), s, postop=post).numpy()
        emit(f"shear_rows postop={post}", x.shape, "jax kernel",
             **values(out, jshear.shear_rows(jnp.asarray(x), s, postop=post)))
    emit("shear_rows", x.shape, "fast_warp.shear_rows",
         **values(tshear.shear_rows(torch.from_numpy(x), s).numpy(), ofw.shear_rows(x, s)))
    s2 = ((rng.random((2, 48)) - 0.5) * 20.0).astype(np.float32)
    for pad in (None, 3):
        out = tshear.shear_rows_per_image(torch.from_numpy(x), s2, pad_px=pad).numpy()
        emit(f"shear_rows_per_image pad_px={pad}", x.shape, "jax kernel",
             **values(out, jshear.shear_rows_per_image(jnp.asarray(x), s2, pad_px=pad)))
    for a in (0.0, 15.0, -44.0, 60.0, -80.0):
        out = tshear.rotate_3shear(torch.from_numpy(x), a).numpy()
        emit(f"rotate_3shear {a}", x.shape, "jax kernel",
             **values(out, jshear.rotate_3shear(jnp.asarray(x), a)))
        emit(f"rotate_3shear {a}", x.shape, "fast_warp.rotate_3shear",
             **values(out, ofw.rotate_3shear(x, a)))
    img = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    out = tshear.blur_rotate_fused(torch.from_numpy(img), 1.5, 15.0, grayscale_out=True).numpy()
    emit("blur_rotate_fused r 1.5 15 gray", img.shape, "jax kernel",
         **values(out, jshear.blur_rotate_fused(jnp.asarray(img), 1.5, 15.0,
                                                grayscale_out=True)))
    blurred = np.stack([ost.gaussian_blur(im, 1.5) for im in img])
    emit("blur_rotate_fused r 1.5 15 gray", img.shape, "f64 blur oracle -> fast_warp -> L24",
         **values(out, np.stack([oe.grayscale_rgb(im) for im in ofw.rotate_3shear(blurred, 15.0)])))


def ops_and_chains() -> None:
    """The FMA-budgeted ops and the chain routes that differ from JAX
    (tests/test_torch_ops.py, tests/test_torch_chain_full.py)."""
    imgs = np.random.default_rng(1234).integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    x, t = jnp.asarray(imgs), torch.from_numpy(imgs)
    for name, port, jax_fn in (
        ("enhance_contrast 1.3", lambda: tew.enhance_contrast(t, 1.3),
         lambda: jops.enhance_contrast(x, 1.3)),
        ("enhance_color 0.6", lambda: tew.enhance_color(t, 0.6),
         lambda: jops.enhance_color(x, 0.6)),
        ("sharpen 1.5", lambda: tst.sharpen(t, 1.5), lambda: jst.sharpen(x, 1.5)),
        ("sharpen 0.3", lambda: tst.sharpen(t, 0.3), lambda: jst.sharpen(x, 0.3)),
    ):
        emit(name, imgs.shape, "jax (XLA-CPU FMA)", **values(port().numpy(), jax_fn()))
    chains = {
        "rotation 60": ([("rotation", {"angle": 60.0})], {}),
        "rotation [5, -50]": ([("rotation", {"angle": np.asarray([5.0, -50.0], np.float32)})],
                              {}),
        "translation>zoom>rotation(10)": ([("translation", {"tx": 3, "ty": -2}),
                                           ("zoom", {"factor": 1.2}),
                                           ("rotation", {"angle": 10.0})], {}),
        "zoom 1.3": ([("zoom", {"factor": 1.3})], {}),
        "strict blur>rotation(15)>gray": ([("blur", {"radius": 1.5}),
                                           ("rotation", {"angle": 15.0}), ("grayscale", {})],
                                          {"strict_parity": True}),
        "strict zoom>contrast>brightness>rotation(0)": (
            [("zoom", {"factor": 1.2}), ("contrast", {"alpha": 1.2}),
             ("brightness", {"factor": 0.05}), ("rotation", {"angle": 0.0})],
            {"strict_parity": True}),
        "photometric": ([("brightness", {"factor": 0.05}), ("contrast", {"alpha": 1.2}),
                         ("sharpness", {"factor": 1.5}), ("histogram_equalization", {}),
                         ("invert", {})], {}),
    }
    for name, (ops, kw) in chains.items():
        out = tchain.build_chain_fn([tchain.OpSpec(n, dict(p)) for n, p in ops], device="cpu",
                                    **kw)(imgs).numpy()
        want = jchain.build_chain_fn([jchain.OpSpec(n, dict(p)) for n, p in ops], **kw)(x)
        emit(f"build_chain_fn {name}", imgs.shape, "jax build_chain_fn",
             **values(out, want), **pixels(out, want))


if __name__ == "__main__":
    sys.exit(main())
