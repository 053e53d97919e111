"""Batched image ops (PyTorch), on the image tensor's device.

The per-op API of the JAX package's ``ops`` (the same 31 names): every
function is batched (NHWC, or HWC for one image) and takes a scalar or one
parameter an image. ``ops.hopper`` holds the wrappers of the hand-written
CUDA kernels; ``ops.composite`` and ``ops.corruptions`` are imported by
name, as in the JAX package.
"""

from imagetransformations_tpu_torch.ops.elementwise import (  # noqa: F401
    apply_brightness,
    apply_contrast,
    enhance_color,
    enhance_contrast,
    grayscale,
    invert,
)
from imagetransformations_tpu_torch.ops.noise import (  # noqa: F401
    apply_gaussian_noise,
    gaussian_noise_01,
    impulse_noise,
    shot_noise,
)
from imagetransformations_tpu_torch.ops.stencil import (  # noqa: F401
    apply_blur,
    gaussian_blur,
    motion_blur,
    pil_box_blur,
    pil_gaussian_blur,
    sharpen,
    sobel_edges,
)
from imagetransformations_tpu_torch.ops.warp import (  # noqa: F401
    affine_warp,
    apply_perspective,
    apply_rotation,
    apply_scale,
    apply_scale_batched,
    apply_shear,
    apply_translation,
    center_crop,
    flip_vertical,
    perspective_coeffs,
    perspective_warp,
    random_zoom,
)
from imagetransformations_tpu_torch.ops.histogram import (  # noqa: F401
    histogram_equalization,
    image_entropy,
)
