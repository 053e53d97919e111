"""Declarative op-chains, the 8-type batch sweep, folder I/O and batch
sharding over a one-process device mesh (PyTorch). Counterpart of
``imagetransformations_tpu/pipeline``."""

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
    global_batch_from_host_shards,
    load_folder_images,
    prefetch_to_device,
    shard_files_for_host,
)
from imagetransformations_tpu_torch.pipeline.sharding import (  # noqa: F401
    Mesh,
    ShardedBatch,
    data_mesh,
    shard_images,
    sharded_apply,
)
