"""Typed configuration, checkpoints, profiling and the demo model (PyTorch).
Counterpart of ``imagetransformations_tpu/utils``."""

from imagetransformations_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from imagetransformations_tpu_torch.utils.config import (  # noqa: F401
    FrameworkConfig,
    RefineConfig,
    SweepConfig,
)
from imagetransformations_tpu_torch.utils.profiling import op_throughput, trace  # noqa: F401
