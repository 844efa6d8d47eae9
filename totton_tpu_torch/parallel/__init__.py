"""Multi-device and multi-process execution on torch.

Counterpart of ``totton_tpu.parallel``: channels and time spans shard over
a 2D ``Mesh('channel', 'time')`` of torch devices. Overlap-save needs only
the previous taps-1 *input* samples of each time span, so time
parallelism is exact: each span takes its halo from its left neighbour,
a slice of the input inside one process and a point-to-point send of
halo_in input-rate samples per mesh row between processes.
"""

from totton_tpu_torch.parallel.mesh import Mesh, make_mesh
from totton_tpu_torch.parallel.sharded import (
    ShardedUpsampler,
    make_sharded_step,
    sharded_upsample,
)
from totton_tpu_torch.parallel.distributed import initialize_distributed

__all__ = [
    "Mesh",
    "make_mesh",
    "ShardedUpsampler",
    "make_sharded_step",
    "sharded_upsample",
    "initialize_distributed",
]
