"""The port's CIFAR-10-C generators (``ops/corruptions.py`` and the store's
noise ops) against the JAX package's and the numpy oracle, on the CPU.

For each of the store's 19 generators plus ``elastic_transform``, the
explicit draws are made once with numpy from a seed and handed to the
port, to the JAX op (``imagetransformations_tpu.ops``) and to the oracle
(``imagetransformations_tpu.oracle``). The gates are those of
tests/test_corruptions.py: 1 LSB; ``jpeg_compression`` more than 1 LSB on at
most 0.5% of values and at most 32 (a flipped quantization bin moves one
8x8 block by up to a quantization step). ``shot_noise`` has no draw keyword
in the JAX op: the port's ``draw=`` is held to the oracle, and the port's
and JAX's own draws to the Poisson moments. Also mirrored: the canonical
suite, every corruption batched at severities 1 and 5, fog at an odd size,
the pure-affine severity 1 of the elastic corruption, contrast keeping the
mean; and the severity tables equal JAX's value for value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu.ops import corruptions as jc
from imagetransformations_tpu.ops import noise as jnz
from imagetransformations_tpu.oracle import corruptions as oc
from imagetransformations_tpu.oracle import elementwise as oe

from imagetransformations_tpu_torch.evalx import harness as th
from imagetransformations_tpu_torch.ops import _corruption_host as host
from imagetransformations_tpu_torch.ops import corruptions as tc
from imagetransformations_tpu_torch.ops import noise as tnz

N, H, W = 2, 24, 28


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lsb(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


def _per_image(fn, imgs, *draws):
    """The oracle, one image at a time, with image i's slice of each draw."""
    return np.stack([fn(imgs[i], *(d[i] for d in draws)) for i in range(imgs.shape[0])])


def _case(name, sev, rng, imgs):
    """(port output, JAX output, oracle output) of store generator ``name``
    at ``sev``, all three fed the same numpy draws."""
    n, h, w, _ = imgs.shape
    x, xj = _t(imgs), jnp.asarray(imgs)
    if name == "gaussian_noise":
        s = jc.GAUSSIAN_NOISE_SEV[sev - 1]
        z = rng.standard_normal(imgs.shape).astype(np.float32)
        return (tnz.gaussian_noise_01(x, s, noise=_t(z)), jnz.gaussian_noise_01(xj, s, noise=z),
                _per_image(lambda im, zi: oe.gaussian_noise_01(im, s, zi), imgs, z))
    if name == "impulse_noise":
        a = jc.IMPULSE_NOISE_SEV[sev - 1]
        u = rng.random((n, h, w)).astype(np.float32)
        return (tnz.impulse_noise(x, a, u=_t(u)), jnz.impulse_noise(xj, a, u=u),
                _per_image(lambda im, ui: oe.impulse_noise(im, a, ui), imgs, u))
    if name == "speckle_noise":
        c = jc.SPECKLE_SEV[sev - 1]
        z = rng.standard_normal(imgs.shape).astype(np.float32)
        return (tc.speckle_noise(x, c, noise=_t(z)), jc.speckle_noise(xj, c, noise=z),
                _per_image(lambda im, zi: oc.speckle_noise(im, c, zi), imgs, z))
    if name == "defocus_blur":
        r, a = jc.DEFOCUS_SEV[sev - 1]
        return (tc.defocus_blur_disk(x, r, a), jc.defocus_blur_disk(xj, r, a),
                _per_image(lambda im: oc.defocus_blur_disk(im, r, a), imgs))
    if name == "glass_blur":
        s, d, it = jc.GLASS_BLUR_SEV[sev - 1]
        off = rng.integers(-d, d, (it, n, h, w, 2)).astype(np.int32)
        return (tc.glass_blur(x, s, d, it, offsets=_t(off)),
                jc.glass_blur(xj, s, d, it, offsets=jnp.asarray(off)),
                np.stack([oc.glass_blur(imgs[i], s, d, it, off[:, i]) for i in range(n)]))
    if name == "motion_blur":
        r, s = jc.MOTION_SEV[sev - 1]
        ang = rng.uniform(-45.0, 45.0, n).astype(np.float32)
        return (tc.motion_blur_directional(x, r, s, angles_deg=_t(ang)),
                jc.motion_blur_directional(xj, r, s, angles_deg=jnp.asarray(ang)),
                _per_image(lambda im, a: oc.motion_blur_directional(im, r, s, float(a)), imgs,
                           ang))
    if name == "zoom_blur":
        z = jc.ZOOM_BLUR_SEV[sev - 1]
        return (tc.zoom_blur(x, z), jc.zoom_blur(xj, z),
                _per_image(lambda im: oc.zoom_blur(im, z), imgs))
    if name == "snow":
        p = jc.SNOW_SEV[sev - 1]
        g = rng.standard_normal((n, h, w)).astype(np.float32)
        ang = rng.uniform(-135.0, -45.0, n).astype(np.float32)
        return (tc.snow(x, *p, g_noise=_t(g), angles_deg=_t(ang)),
                jc.snow(xj, *p, g_noise=g, angles_deg=ang),
                _per_image(lambda im, gi, a: oc.snow(im, *p, g_noise=gi, angle_deg=float(a)),
                           imgs, g, ang))
    if name == "frost":
        c0, c1 = jc.FROST_SEV[sev - 1]
        us, ua = rng.random((n, h, w)).astype(np.float32), rng.random((n, h, w)).astype(np.float32)
        g = rng.standard_normal((n, h, w)).astype(np.float32)
        return (tc.frost(x, c0, c1, u_seed=_t(us), u_amp=_t(ua), g_noise=_t(g)),
                jc.frost(xj, c0, c1, u_seed=us, u_amp=ua, g_noise=g),
                _per_image(lambda im, a, b, c: oc.frost(im, c0, c1, a, b, c), imgs, us, ua, g))
    if name == "fog":
        st, dec = jc.FOG_SEV[sev - 1]
        size = tc.fog_size(h, w)
        dr = rng.uniform(-1.0, 1.0, (n, tc.plasma_levels(size), size, size)).astype(np.float32)
        return (tc.fog(x, st, dec, draws=_t(dr)), jc.fog(xj, st, dec, draws=jnp.asarray(dr)),
                _per_image(lambda im, d: oc.fog(im, st, dec, d), imgs, dr))
    if name == "brightness":
        c = jc.BRIGHTNESS_SEV[sev - 1]
        return (tc.brightness_hsv(x, c), jc.brightness_hsv(xj, c),
                _per_image(lambda im: oc.brightness_hsv(im, c), imgs))
    if name == "contrast":
        c = jc.CONTRAST_SEV[sev - 1]
        return (tc.contrast_meanpreserve(x, c), jc.contrast_meanpreserve(xj, c),
                _per_image(lambda im: oc.contrast_meanpreserve(im, c), imgs))
    if name == "elastic_transform":  # the store's: affine, then displacement
        a, s, aa = jc.elastic_affine_params(h, w, sev)
        jit = rng.uniform(-aa, aa, (n, 3, 2)).astype(np.float32)
        disp = rng.uniform(-1.0, 1.0, (n, h, w, 2)).astype(np.float32)
        return (tc.elastic_transform_affine(x, a, s, aa, disp=_t(disp), jitter=_t(jit)),
                jc.elastic_transform_affine(xj, a, s, aa, disp=jnp.asarray(disp),
                                            jitter=jnp.asarray(jit)),
                _per_image(lambda im, d, j: oc.elastic_transform_affine(im, a, s, d, j), imgs,
                           disp, jit))
    if name == "elastic_transform_legacy":  # the displacement-only recipe
        a, s = jc.elastic_params(h, w, sev)
        disp = rng.uniform(-1.0, 1.0, (n, h, w, 2)).astype(np.float32)
        return (tc.elastic_transform(x, a, s, disp=_t(disp)),
                jc.elastic_transform(xj, a, s, disp=jnp.asarray(disp)),
                _per_image(lambda im, d: oc.elastic_transform(im, a, s, d), imgs, disp))
    if name == "pixelate":
        f = jc.PIXELATE_SEV[sev - 1]
        return (tc.pixelate(x, f), jc.pixelate(xj, f),
                _per_image(lambda im: oc.pixelate(im, f), imgs))
    if name == "jpeg_compression":
        q = jc.JPEG_SEV[sev - 1]
        return (tc.jpeg_compression(x, q), jc.jpeg_compression(xj, q),
                _per_image(lambda im: oc.jpeg_compression(im, q), imgs))
    if name == "gaussian_blur":
        s = jc.GAUSSIAN_BLUR_SEV[sev - 1]
        return (tc.gaussian_blur_sigma_op(x, s), jc.gaussian_blur_sigma_op(xj, s),
                _per_image(lambda im: oc.gaussian_blur_sigma_u8(im, s), imgs))
    if name == "spatter":
        p = jc.SPATTER_SEV[sev - 1]
        g = rng.standard_normal((n, h, w)).astype(np.float32)
        return (tc.spatter(x, *p, g_noise=_t(g)), jc.spatter(xj, *p, g_noise=jnp.asarray(g)),
                _per_image(lambda im, gi: oc.spatter(im, *p, g_noise=gi), imgs, g))
    if name == "saturate":
        a, b = jc.SATURATE_SEV[sev - 1]
        return (tc.saturate_hsv(x, a, b), jc.saturate_hsv(xj, a, b),
                _per_image(lambda im: oc.saturate_hsv(im, a, b), imgs))
    raise KeyError(name)


EXPLICIT = ["gaussian_noise", "impulse_noise", "defocus_blur", "glass_blur", "motion_blur",
            "zoom_blur", "snow", "frost", "fog", "brightness", "contrast", "elastic_transform",
            "pixelate", "jpeg_compression", "speckle_noise", "gaussian_blur", "spatter",
            "saturate", "elastic_transform_legacy"]


@pytest.mark.parametrize("sev", [1, 5])
@pytest.mark.parametrize("name", EXPLICIT)
def test_generator_matches_jax_and_oracle(rng, name, sev):
    imgs = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    got, want_jax, want_oracle = _case(name, sev, rng, imgs)
    got = got.numpy()
    assert got.shape == imgs.shape and got.dtype == np.uint8
    for want in (np.asarray(want_jax), want_oracle):
        d = _lsb(got, want)
        if name == "jpeg_compression":
            assert (d > 1).mean() <= 0.005 and d.max() <= 32
        else:
            assert d.max() <= 1, (name, sev, int(d.max()))


def test_shot_noise_draw_and_moments(rng):
    imgs = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    lam = jc.SHOT_NOISE_SEV[4]
    draw = rng.poisson(imgs.astype(np.float64) / 255.0 * lam).astype(np.float32)
    got = tnz.shot_noise(_t(imgs), lam, draw=_t(draw)).numpy()
    assert _lsb(got, _per_image(lambda im, d: oe.shot_noise(im, lam, d), imgs, draw)).max() <= 1
    flat = np.full((4, 32, 32, 3), 128, np.uint8)
    port = tnz.shot_noise(_t(flat), lam, generator=torch.Generator().manual_seed(1)).numpy()
    jax_ = np.asarray(jnz.shot_noise(jnp.asarray(flat), lam, key=jax.random.key(1)))
    sd = 255.0 * np.sqrt(128 / 255.0 * lam) / lam  # Poisson: var = mean
    for out in (port, jax_):
        assert abs(out.mean() - 128.0) < 1.0 and abs(out.std() - sd) < 1.0


def test_severity_tables_equal_jax():
    for name in ("GLASS_BLUR_SEV", "FOG_SEV", "FROST_SEV", "SNOW_SEV", "ELASTIC_SEV",
                 "ELASTIC_AFFINE_SEV", "PIXELATE_SEV", "JPEG_SEV", "ZOOM_BLUR_SEV",
                 "GAUSSIAN_NOISE_SEV", "SHOT_NOISE_SEV", "IMPULSE_NOISE_SEV", "DEFOCUS_SEV",
                 "MOTION_SEV", "CONTRAST_SEV", "BRIGHTNESS_SEV", "SPECKLE_SEV",
                 "GAUSSIAN_BLUR_SEV", "SPATTER_SEV", "SATURATE_SEV"):
        assert getattr(tc, name) == getattr(jc, name), name
    for h, w, sev in ((32, 32, 1), (24, 40, 4), (5, 9, 5)):
        assert tc.elastic_affine_params(h, w, sev) == jc.elastic_affine_params(h, w, sev)
        assert tc.elastic_params(h, w, sev) == jc.elastic_params(h, w, sev)
    assert tc.plasma_levels(256) == jc.plasma_levels(256) == 8


def test_host_tables_equal_the_oracle():
    np.testing.assert_array_equal(host.dct_matrix(), oc.dct_matrix())
    for q in (80, 40, 10, 100):
        for a, b in zip(host.jpeg_quant_tables(q), oc.jpeg_quant_tables(q)):
            np.testing.assert_array_equal(a, b)
    for s in (0.33, 0.52, 1.2, 2.0, 0.0):
        np.testing.assert_array_equal(host.gauss_taps_sigma(s), oc.gauss_taps_sigma(s))
    for z in (1.06, 1.26):
        np.testing.assert_array_equal(host.zoom_factors(z), oc.zoom_factors(z))
        np.testing.assert_array_equal(host.clipped_zoom_coords(37, z),
                                      oc.clipped_zoom_coords(37, z))
    np.testing.assert_array_equal(host.nearest_resize_map(50, 53), oc.nearest_resize_map(50, 53))
    for r, a in tc.DEFOCUS_SEV:
        np.testing.assert_array_equal(host.disk_kernel(r, a), oc.disk_kernel(r, a))
    np.testing.assert_array_equal(host.motion_kernel(6, 1.5, 30.0), oc.motion_kernel(6, 1.5, 30.0))
    np.testing.assert_array_equal(host.elastic_points(24, 40), oc.elastic_points(24, 40))
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 30, (3, 3, 2)).astype(np.float32)
    dst = rng.uniform(0, 30, (3, 3, 2)).astype(np.float32)
    got = host.affine_from_points(src, dst)
    for i in range(3):
        np.testing.assert_array_equal(got[i], oc.affine_from_points(src[i], dst[i]))


def test_motion_kernels_batched_near_the_oracle():
    ang = np.asarray([-30.0, 0.0, 42.0, -135.0], np.float32)
    got = tc._motion_kernels_batched(_t(ang), 8, 2.0).numpy()
    for k, a in zip(got, ang):
        np.testing.assert_allclose(k, host.motion_kernel(8, 2.0, float(a)), rtol=2e-6, atol=1e-12)


def test_corruption_suite_is_canonical():
    canonical = [
        "gaussian_noise", "shot_noise", "impulse_noise",
        "defocus_blur", "glass_blur", "motion_blur",
        "zoom_blur", "snow", "frost", "fog", "brightness",
        "contrast", "elastic_transform", "pixelate", "jpeg_compression",
    ]
    assert list(th.CORRUPTIONS) == canonical


def test_all_corruptions_run_batched(rng):
    imgs = _t(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    g = torch.Generator().manual_seed(7)
    for name in th.CORRUPTIONS:
        for sev in (1, 5):
            out = th.corrupt(imgs, name, sev, g)
            assert out.shape == imgs.shape and out.dtype == torch.uint8, name
            assert not torch.equal(out, imgs), (name, sev)


def test_fog_odd_size_runs(rng):
    imgs = rng.integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    out = tc.fog(_t(imgs), 0.75, 2.5, generator=torch.Generator().manual_seed(0)).numpy()
    assert out.shape == imgs.shape and out.dtype == np.uint8
    assert not np.array_equal(out, imgs)


def test_elastic_affine_sev1_is_pure_affine(rng):
    imgs = rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    out = tc.elastic_transform_affine(_t(imgs), 0.0, 1.0, 2.56, jitter=torch.zeros((1, 3, 2)))
    np.testing.assert_array_equal(out.numpy(), imgs)


def test_contrast_meanpreserve_preserves_mean(rng):
    imgs = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    out = tc.contrast_meanpreserve(_t(imgs), 0.3).numpy()
    assert abs(out.mean() - imgs.mean()) < 1.5
