"""The parallel layer: data parallelism over a process group (``mesh``,
``data_parallel``, ``collectives``, ``launch``) — the port of the data
axis of ``semantic_segmentation_tpu/parallel/``."""
from semantic_segmentation_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_data_mesh,
    replicate,
    shard_batch,
)
