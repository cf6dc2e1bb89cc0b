"""Channel, time and feature parallelism over a mesh of torch devices.

Counterpart of ``syllable_detector_tpu.parallel``. The reference's only
parallelism is one independent detector per audio channel: stack the
per-channel network parameters on a leading axis, map the detector over it,
and split that axis across the mesh's shards. Channels never communicate;
a sum across shards appears only for aggregate metrics and for the
feature-sharded form. For one stream too long for a single device the time
axis shards instead, each shard reading a halo from its right neighbour.
"""

from syllable_detector_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    batch_offline_outputs,
    sharded_offline_outputs,
    sharded_fused_offline_outputs,
    sharded_detection_counts,
    sharded_streaming_step,
    time_sharded_offline_outputs,
    tensor_sharded_offline_outputs,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_offline_outputs",
    "sharded_offline_outputs",
    "sharded_fused_offline_outputs",
    "sharded_detection_counts",
    "sharded_streaming_step",
    "time_sharded_offline_outputs",
    "tensor_sharded_offline_outputs",
]
