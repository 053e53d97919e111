"""Channel counts other than 3, and the per-image blur's entry point, on the CPU.

The port's ``grayscale``, ``enhance_contrast``, ``enhance_color`` and
``histogram_equalization`` read channel k as ``min(k, c - 1)``, as the JAX
ops do (JAX clamps an out-of-range index): a 1-channel image is its own
luma. Each is held against the JAX op on the CPU backend at c = 1 and 2:
0 LSB, except ``enhance_color`` at c = 2, whose blend XLA-CPU contracts
into an FMA (<= 1 LSB on <= 1%; measured 0.40% at 2x20x28x2).
``histogram_equalization`` raises ValueError on 2 and 4 or more channels in
both packages.

``blur_separable_batched`` (the per-image blur's kernel entry point) runs
its plain version on the CPU, cv2's integer blur: 0 LSB against
``cv2.GaussianBlur`` at 1, 3 and 4 channels; the JAX per-image blur (f32)
within <= 2 LSB on <= 27% of values (measured: 2 LSB; 1 LSB or more on up
to 25.6% of values, at 11x5x7x3). The zero-tap argument that lets the kernel sum only each
image's taps between its outer nonzero ones is checked here on the plain
passes.
"""

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from imagetransformations_tpu import ops as jops
from imagetransformations_tpu.ops import histogram as jhg
from imagetransformations_tpu.ops import stencil as jst
from imagetransformations_tpu.pipeline import chain as jchain

from imagetransformations_tpu_torch.core import grids as tgrids
from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import histogram as hg
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops.hopper import blur as bl
from imagetransformations_tpu_torch.pipeline import chain as tchain

# (port fn, JAX fn)
OPS = {
    "grayscale": (ew.grayscale, jops.grayscale),
    "grayscale one channel out": (lambda x: ew.grayscale(x, keep_rgb=False),
                                  lambda x: jops.grayscale(x, keep_rgb=False)),
    "enhance_contrast 0.5": (lambda x: ew.enhance_contrast(x, 0.5),
                             lambda x: jops.enhance_contrast(x, 0.5)),
    "enhance_contrast 1.3": (lambda x: ew.enhance_contrast(x, 1.3),
                             lambda x: jops.enhance_contrast(x, 1.3)),
    "enhance_color 0.6": (lambda x: ew.enhance_color(x, 0.6),
                          lambda x: jops.enhance_color(x, 0.6)),
    "histogram_equalization": (hg.histogram_equalization, jhg.histogram_equalization),
}
BLUR_GRID = [float(r) for r in tgrids.PARAM_GRIDS["blur"].values()]


@pytest.mark.parametrize(
    "name,c",
    # histogram_equalization raises at c = 2: test_histogram_equalization_raises
    [(name, c) for name in sorted(OPS) for c in (1, 2)
     if (name, c) != ("histogram_equalization", 2)],
)
def test_op_matches_jax_on_few_channels(rng, name, c):
    port, jax_fn = OPS[name]
    imgs = rng.integers(0, 256, (2, 20, 28, c), dtype=np.uint8)
    out = port(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jax_fn(jnp.asarray(imgs)))
    assert out.shape == want.shape and out.dtype == want.dtype
    err = np.abs(out.astype(int) - want.astype(int))
    if name.startswith("enhance_color") and c == 2:
        assert err.max() <= 1 and (err > 0).mean() <= 0.01, (err.max(), (err > 0).mean())
    else:
        assert err.max() == 0, (err.max(), (err > 0).mean())


def test_one_channel_reads_as_three(rng):
    """A 1-channel image computes as its 3-channel repeat: grayscale and
    histogram equalization give the repeat's 3 channels, the enhance blends
    its first channel."""
    imgs = rng.integers(0, 256, (2, 20, 28, 1), dtype=np.uint8)
    x, x3 = torch.from_numpy(imgs), torch.from_numpy(np.repeat(imgs, 3, axis=-1))
    assert torch.equal(ew.grayscale(x), ew.grayscale(x3))
    assert torch.equal(ew.grayscale(x), x3)  # the identity luma
    assert torch.equal(hg.histogram_equalization(x), hg.histogram_equalization(x3))
    for op in (lambda a: ew.enhance_contrast(a, 0.5), lambda a: ew.enhance_color(a, 0.6)):
        assert torch.equal(op(x), op(x3)[..., :1])


def test_grayscale_of_an_l_image_equals_pil(rng):
    Image = pytest.importorskip("PIL.Image")
    img = rng.integers(0, 256, (20, 28), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img, mode="L").convert("L"))
    out = ew.grayscale(torch.from_numpy(img[None, :, :, None]), keep_rgb=False).numpy()
    assert np.array_equal(out[0, :, :, 0], want)


@pytest.mark.parametrize("c", [2, 4, 5])
def test_histogram_equalization_raises(rng, c):
    imgs = rng.integers(0, 256, (2, 20, 28, c), dtype=np.uint8)
    with pytest.raises(ValueError):
        hg.histogram_equalization(torch.from_numpy(imgs))
    with pytest.raises(ValueError):
        jhg.histogram_equalization(jnp.asarray(imgs))


CHAINS = {
    "grayscale": [("grayscale", {})],
    "rotation 15 > grayscale": [("rotation", {"angle": 15.0}), ("grayscale", {})],
    "enhance_contrast 0.5": [("enhance_contrast", {"factor": 0.5})],
}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_on_one_channel_matches_jax(rng, name, strict):
    ops = CHAINS[name]
    imgs = rng.integers(0, 256, (1, 40, 36, 1), dtype=np.uint8)
    out = tchain.build_chain_fn([tchain.OpSpec(n, p) for n, p in ops], strict_parity=strict,
                                device="cpu")(imgs).numpy()
    want = np.asarray(jchain.build_chain_fn([jchain.OpSpec(n, p) for n, p in ops],
                                            strict_parity=strict)(jnp.asarray(imgs)))
    assert out.shape == want.shape
    assert np.array_equal(out, want)


# ---------------------------------------------------------------- per-image blur


@pytest.mark.parametrize("shape", [(11, 40, 36, 3), (11, 5, 7, 3), (11, 21, 30, 1),
                                   (11, 13, 20, 4)])
def test_blur_separable_batched_on_the_cpu(rng, shape):
    """The CPU route is the plain version; it and ``apply_blur`` with an
    array equal cv2 per image at 0 LSB, and the JAX per-image blur within
    its budget (module docstring)."""
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    radii = rng.permutation(np.asarray(BLUR_GRID, np.float32))
    x, r = torch.from_numpy(imgs), torch.from_numpy(radii)
    out = bl.blur_separable_batched(x, r)
    assert torch.equal(out, st.blur_batched_plain(x, r))
    assert torch.equal(st.apply_blur(x, r), out)
    assert torch.equal(out[radii == 0], x[radii == 0])  # radius 0: a copy
    for im, o, v in zip(imgs, out.numpy(), radii):
        if v > 0:
            k = st.cv2_gaussian_ksize(float(v))
            ref = cv2.GaussianBlur(im, (k, k), float(v)).reshape(im.shape)
            np.testing.assert_array_equal(o, ref)
    want = np.asarray(jst.apply_blur(jnp.asarray(imgs), jnp.asarray(radii)))
    err = np.abs(out.numpy().astype(int) - want.astype(int))
    assert err.max() <= 2 and (err > 0).mean() <= 0.27, (err.max(), (err > 0).mean())


def test_blur_separable_batched_checks_its_arguments(rng):
    x = torch.from_numpy(rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8))
    with pytest.raises(ValueError):
        bl.blur_separable_batched(x, [1.0, 2.0])
    with pytest.raises(ValueError):
        bl.blur_separable_batched(x.float(), [1.0, 2.0, 0.5])


@pytest.mark.parametrize("radius", BLUR_GRID)
def test_zero_padded_taps_equal_trimmed_taps(rng, radius):
    """The kernel sums only the taps of each image's 31-wide integer row
    between its outer nonzero ones (cv2's outer taps may round to 0, as at
    r 5). The plain version with the whole zero-padded row gives the same
    bytes as the same two passes with the trimmed row: 0 LSB, on images
    narrower and wider than the window."""
    for shape in ((2, 40, 36, 3), (2, 5, 7, 3)):
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        r = torch.full((shape[0],), radius, dtype=torch.float32)
        row = st.blur_tap_rows(r, torch.device("cpu"))[0]
        q = int(torch.nonzero(row)[0])
        trimmed = row[q : row.numel() - q]
        taps = st.cv2_taps_q8(radius)
        e = int(np.nonzero(taps)[0][0])
        assert torch.equal(trimmed, torch.from_numpy(taps[e : taps.size - e]))
        assert int(trimmed.sum()) == 256
        assert torch.equal(st.blur_batched_plain(x, r), st._blur_q8(x, trimmed))
