"""Execution over several devices, processes and cameras (PyTorch port of
raw_image_pipeline_tpu/parallel): the [data, space] device mesh and its
sharded batches (mesh.py), the spatial split that runs the chain on slabs
of rows (spatial.py), data parallelism across processes on
torch.distributed (multihost.py), the camera-blocked multicamera chain
(multicamera.py) and the dry run of a sharded step (dryrun.py).

A mesh may repeat a device (logical shards): one card, or the CPU, then
carries several shards, and every sharded call equals the unsharded one
byte for byte. dryrun_multichip stays in dryrun.py, which also runs as
`python -m raw_image_pipeline_tpu_torch.parallel.dryrun`.
"""

from raw_image_pipeline_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBatch,
    batch_sharding,
    make_mesh,
    shard_batch,
    spatial_sharding,
)
from raw_image_pipeline_tpu_torch.parallel.multicamera import (
    build_multicamera_pipeline,
    multicamera_state,
)
from raw_image_pipeline_tpu_torch.parallel.multihost import (
    distribute_batch,
    global_data_mesh,
    initialize_multihost,
)

__all__ = [
    "Mesh",
    "ShardedBatch",
    "batch_sharding",
    "build_multicamera_pipeline",
    "distribute_batch",
    "global_data_mesh",
    "initialize_multihost",
    "make_mesh",
    "multicamera_state",
    "shard_batch",
    "spatial_sharding",
]
