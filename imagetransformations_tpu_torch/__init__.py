"""imagetransformations_tpu_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside ``imagetransformations_tpu`` (the JAX reference).
It imports PyTorch and numpy, never JAX. Ported so far: the fused
blur -> rotate -> grayscale chain (``build_chain_fn`` for static and
per-image angles, ``fused_blur_rotate_image``, ``fused_blur_rotate_batched``),
the reference's 8-type sweep ``apply_all_transformations`` with every flag
combination, and the warp ops ``apply_rotation``, ``random_zoom``,
``apply_shear`` and ``affine_warp``. Hand-written CUDA kernels in ``csrc/``
carry the fused rotation, the BICUBIC shear, the row-shift shear, the
bilinear zoom and the PIL NEAREST rotation on the card; they are built with
nvcc at first use.

- ``core``     : NHWC uint8 batch helpers, u8 quantizations, parameter grids.
- ``ops``      : elementwise, blur, noise, affine warps and LANCZOS scale
                 in plain PyTorch; ``ops.hopper`` holds the kernel
                 wrappers, their plain PyTorch versions and the build.
- ``pipeline`` : declarative op-chains and the 8-type batch sweep.
"""

__version__ = "0.3.0"

from imagetransformations_tpu_torch.core.grids import PARAM_GRIDS  # noqa: F401
from imagetransformations_tpu_torch.ops.hopper.megakernel import (  # noqa: F401
    fused_blur_rotate_batched,
    fused_blur_rotate_image,
)
from imagetransformations_tpu_torch.ops.warp import (  # noqa: F401
    affine_warp,
    apply_rotation,
    apply_shear,
    random_zoom,
)
from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations  # noqa: F401
from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn  # noqa: F401
