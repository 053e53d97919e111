"""The canonical NHWC u8 batch helpers and the transform-parameter grids
(PyTorch). Counterpart of ``imagetransformations_tpu/core``."""

from imagetransformations_tpu_torch.core.grids import (  # noqa: F401
    PARAM_GRIDS,
    ParamGrid,
    sample_all,
    sample_params,
)
from imagetransformations_tpu_torch.core.image import (  # noqa: F401
    as_batch,
    as_float,
    restore_layout,
    to_uint8_rint,
    to_uint8_trunc,
)
