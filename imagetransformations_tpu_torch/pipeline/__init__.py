"""Declarative op-chains, the 8-type batch sweep and folder I/O (PyTorch).
Counterpart of ``imagetransformations_tpu/pipeline``; its multi-device
sharding is not ported (ROADMAP A.9)."""

from imagetransformations_tpu_torch.pipeline.batch import (  # noqa: F401
    apply_all_transformations,
    transform_batch,
)
from imagetransformations_tpu_torch.pipeline.chain import (  # noqa: F401
    Chain,
    OpSpec,
    build_chain_fn,
)
from imagetransformations_tpu_torch.pipeline.io import (  # noqa: F401
    load_folder_images,
    prefetch_to_device,
    shard_files_for_host,
)
