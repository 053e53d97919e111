"""Hand-written CUDA kernels for Hopper and their wrappers.

The counterparts of ``imagetransformations_tpu/ops/pallas``: every Pallas
entry point there has an entry point here with the same signature. Each
wrapper launches its kernel (``csrc/*.cu``, built by ``_lib``) on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor.
"""

from imagetransformations_tpu_torch.ops.hopper.blur import (  # noqa: F401
    blur_separable,
    blur_separable_batched,
    blur_to_sheared_rows,
)
from imagetransformations_tpu_torch.ops.hopper.megakernel import (  # noqa: F401
    fused_blur_rotate_batched,
    fused_blur_rotate_image,
)
from imagetransformations_tpu_torch.ops.hopper.resample import (  # noqa: F401
    shear_bicubic_batched,
    zoom_bilinear_batched,
)
from imagetransformations_tpu_torch.ops.hopper.rotate_gather import (  # noqa: F401
    pil_rotate_nearest_batched,
)
from imagetransformations_tpu_torch.ops.hopper.shear import (  # noqa: F401
    blur_rotate_fused,
    rotate_3shear,
    rotate_3shear_batched,
    shear_rows,
    shear_rows_logrouted,
    shear_rows_per_image,
)
