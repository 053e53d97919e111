"""The port's exactness scope on 2 and 4 channels (CPU): PIL-exact on 1 and
3 channels; 2 and 4 channels resampled per channel.

The reference opens every image as RGB, so the port does not implement
Pillow's premultiplied-alpha rule for LA / RGBA: on 4 channels each
channel of ``pil_resize`` is PIL's "L" resize of that channel alone (and
the same holds for 2 channels), 0 LSB.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from imagetransformations_tpu_torch.ops.warp import pil_resize

FILTERS = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR, "box": Image.BOX}


@pytest.mark.parametrize("method", sorted(FILTERS))
@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("shape,out", [((37, 53), (29, 61)), ((40, 48), (48, 40)),
                                       ((9, 5), (20, 3))])
def test_each_channel_is_pil_l_resize(method, c, shape, out):
    rng = np.random.default_rng(c + shape[0])
    x = rng.integers(0, 256, (2, *shape, c), dtype=np.uint8)
    x[..., -1] = rng.integers(0, 2, (2, *shape), dtype=np.uint8) * 255  # a binary alpha
    got = pil_resize(torch.from_numpy(x), out[1], out[0], method).numpy()
    assert got.shape == (2, *out, c)
    for i in range(2):
        for k in range(c):
            want = np.asarray(Image.fromarray(x[i, ..., k], "L").resize(
                (out[1], out[0]), FILTERS[method]))
            np.testing.assert_array_equal(got[i, ..., k], want)
