"""imagetransformations_tpu_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside ``imagetransformations_tpu`` (the JAX reference).
It imports PyTorch and numpy, never JAX. Ported so far: the fused
blur -> rotate -> grayscale chain (``build_chain_fn`` for static angles and
``fused_blur_rotate_image``), carried on the card by hand-written CUDA
kernels in ``csrc/`` that are built with nvcc at first use.

- ``core``     : NHWC uint8 batch helpers and the u8 quantizations.
- ``ops``      : host-side constants; ``ops.hopper`` holds the kernel
                 wrappers, their plain PyTorch versions and the build.
- ``pipeline`` : declarative op-chains.
"""

__version__ = "0.1.0"

from imagetransformations_tpu_torch.ops.hopper.megakernel import (  # noqa: F401
    fused_blur_rotate_image,
)
from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn  # noqa: F401
