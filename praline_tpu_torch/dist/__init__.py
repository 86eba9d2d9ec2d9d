"""Distribution on ``torch.distributed``: pair meshes, pair-space sharding
and the ring-parallel single alignment (the counterpart of
``praline_tpu/dist/``)."""

from .allpairs import sharded_wavefront_dp
from .mesh import (
    PAIR_AXIS,
    PairMesh,
    initialize_distributed,
    make_pair_mesh,
    process_index,
    shard_bounds,
    shutdown_distributed,
    single_device_mesh,
)
from .ring import ring_wavefront_dp

__all__ = [
    "PAIR_AXIS",
    "PairMesh",
    "initialize_distributed",
    "make_pair_mesh",
    "process_index",
    "ring_wavefront_dp",
    "shard_bounds",
    "sharded_wavefront_dp",
    "shutdown_distributed",
    "single_device_mesh",
]
