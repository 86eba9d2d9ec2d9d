"""Distribution on ``torch.distributed``: pair meshes and pair-space
sharding (the counterpart of ``praline_tpu/dist/``, less ``ring.py``)."""

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

__all__ = [
    "PAIR_AXIS",
    "PairMesh",
    "initialize_distributed",
    "make_pair_mesh",
    "process_index",
    "shard_bounds",
    "sharded_wavefront_dp",
    "shutdown_distributed",
    "single_device_mesh",
]
