"""imagetransformations_tpu_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside ``imagetransformations_tpu`` (the JAX reference).
It imports PyTorch and numpy, never JAX. Ported: ``build_chain_fn`` with
every op and route of the JAX dispatcher (fused blur -> rotate ->
grayscale for static and per-image angles, strict parity, affine-run
fusion, HWC and float32 input), ``fused_blur_rotate_image`` and
``fused_blur_rotate_batched`` at any angle and image size, the reference's
8-type sweep ``apply_all_transformations`` with every flag combination,
the warp ops ``apply_rotation``, ``random_zoom``, ``apply_shear`` and
``affine_warp``, and every Pallas entry point of the JAX package
(``ops.hopper``: ``blur_separable``, ``shear_rows``,
``shear_rows_per_image``, ``rotate_3shear``, ``blur_rotate_fused``, ...),
plus ``blur_separable_batched``, the per-image blur of the sweep.
Hand-written CUDA kernels in ``csrc/``, one or more for each of the JAX
package's twelve Pallas kernels, carry them on the card; they are built with
nvcc at first use.

- ``core``     : NHWC uint8 batch helpers, u8 quantizations, parameter grids.
- ``ops``      : elementwise, stencil, noise, histogram, affine warps and
                 LANCZOS scale in plain PyTorch; ``ops.hopper`` holds the
                 kernel wrappers, their plain PyTorch versions and the build.
- ``pipeline`` : declarative op-chains and the 8-type batch sweep.
"""

__version__ = "0.4.0"

from imagetransformations_tpu_torch.core.grids import PARAM_GRIDS  # noqa: F401
from imagetransformations_tpu_torch.ops.hopper import (  # noqa: F401
    blur_rotate_fused,
    blur_separable,
    blur_separable_batched,
    blur_to_sheared_rows,
    fused_blur_rotate_batched,
    fused_blur_rotate_image,
    rotate_3shear,
    shear_rows,
    shear_rows_per_image,
)
from imagetransformations_tpu_torch.ops.warp import (  # noqa: F401
    affine_warp,
    apply_rotation,
    apply_shear,
    random_zoom,
)
from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations  # noqa: F401
from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn  # noqa: F401
