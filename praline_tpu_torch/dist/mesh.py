"""Pair-space meshes on ``torch.distributed``.

Counterpart of ``praline_tpu/dist/mesh.py``.  The JAX package shards the
batch axis of a chunk over a ``jax.sharding.Mesh`` with one axis,
``pairs``; the port's mesh is a :class:`PairMesh`: the devices this process
drives (one shard each), its rank among the processes, their number and the
global shard count.  The JAX names map as follows:

- ``make_pair_mesh`` -> :func:`make_pair_mesh`, returning a
  :class:`PairMesh`;
- ``pair_sharding(mesh)`` (the leading batch axis split over ``pairs``)
  and ``replicated(mesh)`` (the whole array on every device) ->
  :func:`shard_bounds`, the contiguous rows of a batch that each shard
  owns; what the JAX package replicates (profile stacks, the substitution
  matrix) the port uploads once to each device this process drives;
- ``jax.distributed.initialize`` -> :func:`initialize_distributed`, a
  ``torch.distributed`` process group on gloo.

Every process of a multi-process mesh runs the same code on the same pairs
(SPMD, as under ``jax.distributed``); the sharded stages gather host
results over the process group (``dist/shards.py``), so gloo carries
them, and two processes may share one card, which NCCL refuses.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as torch_dist

from ..device import resolve_device

PAIR_AXIS = "pairs"
# A collective that waits longer than this raises instead of hanging: a
# rank that failed leaves the others in their next gather.
DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Multi-process bring-up: a gloo process group at
    ``tcp://{coordinator_address}`` (``host:port``); a no-op for one
    process.  Call it once a process before :func:`make_pair_mesh`."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address and process_id")
    torch_dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}", rank=process_id,
        world_size=num_processes, timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown_distributed() -> None:
    """Destroy the process group of :func:`initialize_distributed`, if any,
    so that another can form in this process."""
    if torch_dist.is_initialized():
        torch_dist.destroy_process_group()


def process_count() -> int:
    return torch_dist.get_world_size() if torch_dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group), the JAX package's
    ``jax.process_index()``: rank 0 writes the checkpoints."""
    return torch_dist.get_rank() if torch_dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class PairMesh:
    """A 1-D mesh over the pair axis.  ``devices`` are this process's
    shards, in order: global shards ``first_shard`` to ``first_shard +
    len(devices) - 1`` of ``shards``.  ``sharing`` is how many processes
    drive the device of this one's shards (their chunks split its memory)."""

    devices: tuple[torch.device, ...]
    rank: int
    world_size: int
    shards: int
    first_shard: int
    sharing: int = 1

    @property
    def spans_processes(self) -> bool:
        return self.world_size > 1

    @property
    def local_shards(self) -> range:
        return range(self.first_shard, self.first_shard + len(self.devices))


def make_pair_mesh(n_devices: int | None = None, devices=None, *, device="cuda") -> PairMesh:
    """A pair mesh of ``n_devices`` shards on devices of type ``device``.

    One process: the first ``n_devices`` cards (all of them by default,
    or of ``devices``, where given), ``ValueError`` where fewer exist; on
    ``device="cpu"``, ``n_devices`` shards (default 1) on the CPU.  Several
    processes (after :func:`initialize_distributed`): ``n_devices`` (default
    one a process) must be a multiple of the process count; each process
    owns an equal contiguous run of the shards, all on its one device:
    ``cuda:(rank % torch.cuda.device_count())``, so that two ranks on one
    card share ``cuda:0``, or the CPU."""
    kind = resolve_device(device).type
    world, rank = process_count(), process_index()
    if world > 1:
        if devices is not None:
            raise ValueError("a mesh across processes takes each rank's device; pass no devices")
        n = world if n_devices is None else n_devices
        if n < world or n % world:
            raise ValueError(f"a mesh across {world} processes needs a multiple of {world} "
                             f"shards, got {n}")
        if kind == "cuda":
            count = torch.cuda.device_count()
            dev = torch.device("cuda", rank % count)
            sharing = sum(1 for q in range(world) if q % count == rank % count)
        else:
            dev, sharing = torch.device("cpu"), 1
        per = n // world
        return PairMesh((dev,) * per, rank, world, n, rank * per, sharing)
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"need at least one shard, got {n}")
        return PairMesh((torch.device("cpu"),) * n, 0, 1, n, 0)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("need at least one device")
    return PairMesh(tuple(devices), 0, 1, len(devices), 0)


def single_device_mesh(device: torch.device) -> PairMesh:
    """One shard on ``device``, in this process alone (even inside a process
    group): what a batch call without a mesh runs on."""
    return PairMesh((device,), 0, 1, 1, 0)


def shard_bounds(mesh: PairMesh, B: int) -> list[tuple[int, int]]:
    """``[(lo, hi)]`` for each of the mesh's shards: the contiguous rows of a
    batch of ``B`` it owns, the first ``B % shards`` shards one row more
    than the rest (shards past ``B`` own none)."""
    base, extra = divmod(B, mesh.shards)
    bounds, lo = [], 0
    for s in range(mesh.shards):
        hi = lo + base + (s < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds
