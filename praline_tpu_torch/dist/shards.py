"""The sharding layer under the batch drivers.

Every chunk that ``kernels/batch.py`` has routed and sized runs through
:func:`run_shards`: the chunk's rows split into the mesh's contiguous shards
(``mesh.shard_bounds``), the same per-device body (``batch.dispatch``,
``batch.composite_dp``) on each shard this process drives, and
:meth:`ShardedChunk.gather` brings every shard's results to the host in input
order: on one process by concatenation, across processes by gloo
``all_gather`` of padded host tensors (the terminals first; then the move
tapes, cut to the longest tape of the chunk).  A call without a mesh is one
shard on its device (:func:`~.mesh.single_device_mesh`).  Every problem's
results are the one-shard call's, bit for bit, for any shard count: a
problem's DP reads no other problem.

This module knows the chunks' outputs (the terminals, ``moves``/``nmoves``
and ``tb``) and the process group, nothing of the kernels.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.distributed as torch_dist

from ..util.metrics import span
from .mesh import PairMesh, shard_bounds

TERMINALS = ("score", "length", "ti", "tj", "tcode")
_FLOATS = ("score", "length")  # gathered as their int32 bits


def min_over_ranks(mesh: PairMesh, value: int) -> int:
    """The least of ``value`` over the mesh's processes, so that every rank
    sizes its chunks alike."""
    if not mesh.spans_processes:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    torch_dist.all_reduce(t, op=torch_dist.ReduceOp.MIN)
    return int(t.item())


class ShardedChunk:
    """The outputs of one chunk's local shards, as enqueued;
    :meth:`gather` collects every shard's rows on the host."""

    def __init__(self, mesh: PairMesh, bounds, outs, name: str):
        self.mesh, self.bounds, self.outs, self.name = mesh, bounds, outs, name

    def gather(self) -> dict[str, torch.Tensor]:
        """Every shard's outputs, on the host, in the chunk's row order:
        the terminals and ``moves``/``nmoves`` or ``tb`` where the shards
        made them (``moves`` as wide as the chunk's longest tape, across
        processes)."""
        with span(f"gather:sharded:{self.name}") if self.mesh.shards > 1 else nullcontext():
            host = [None if o is None else {k: v.cpu() for k, v in o.items()} for o in self.outs]
            if not self.mesh.spans_processes:
                return _concat([h for h in host if h is not None])
            return _all_gather(self.mesh, self.bounds, host)


def run_shards(mesh: PairMesh, B: int, shard_fn, name: str) -> ShardedChunk:
    """``shard_fn(lo, hi, device)`` for each shard of a chunk of ``B`` rows
    that this process drives and that owns a row, each under a
    ``dispatch:sharded:`` span naming the shard where there are several;
    the outputs stay enqueued until :meth:`ShardedChunk.gather`."""
    bounds = shard_bounds(mesh, B)
    outs = []
    for s, dev in zip(mesh.local_shards, mesh.devices):
        lo, hi = bounds[s]
        if hi == lo:
            outs.append(None)
            continue
        with (span(f"dispatch:sharded:{name}:shard{s}/{mesh.shards}")
              if mesh.shards > 1 else nullcontext()):
            outs.append(shard_fn(lo, hi, dev))
    return ShardedChunk(mesh, bounds, outs, name)


def _concat(parts: list[dict]) -> dict[str, torch.Tensor]:
    if len(parts) == 1:
        return parts[0]
    return {key: torch.cat([p[key] for p in parts], dim=1 if key == "tb" else 0)
            for key in parts[0]}


def _keys(host: list) -> list[int]:
    """[1, moves, tb, D - 2, Lp] of this rank's first non-empty shard (the
    outputs it made and the shape of its traceback bytes), all 0 where its
    shards are all empty: such a rank learns them from the others."""
    for h in host:
        if h is not None:
            d2, lp = (h["tb"].shape[0], h["tb"].shape[2]) if "tb" in h else (0, 0)
            return [1, int("moves" in h), int("tb" in h), d2, lp]
    return [0] * 5


def _all_gather(mesh: PairMesh, bounds, host: list) -> dict[str, torch.Tensor]:
    """The shards' host outputs across the process group: each rank sends
    its shards padded to the largest shard's rows, so that every tensor of
    a collective has one shape; pad rows are dropped by ``bounds``."""
    rows = max(hi - lo for lo, hi in bounds)
    k = len(mesh.devices)
    # which outputs exist, from the first rank with a non-empty shard
    every = _gather_tensor(mesh, torch.tensor(_keys(host), dtype=torch.int64))
    _, moves, tb, d2, lp = (int(v) for v in next(f for f in every if f[0]))
    fields = TERMINALS + (("nmoves",) if moves else ())
    term = torch.zeros((k * rows, len(fields)), dtype=torch.int32)
    for q, h in enumerate(host):
        if h is None:
            continue
        n = h["score"].shape[0]
        for f, key in enumerate(fields):
            v = h[key]
            term[q * rows : q * rows + n, f] = v.view(torch.int32) if key in _FLOATS else v
    terms = _gather_tensor(mesh, term)
    out_rows = [terms[(s // k)][(s % k) * rows : (s % k) * rows + hi - lo]
                for s, (lo, hi) in enumerate(bounds)]
    allterm = torch.cat(out_rows)
    out = {}
    for f, key in enumerate(fields):
        col = allterm[:, f].contiguous()
        out[key] = col.view(torch.float32) if key in _FLOATS else col
    if moves:
        width = int(out["nmoves"].max()) if out["nmoves"].numel() else 0
        tape = torch.zeros((k * rows, width), dtype=torch.uint8)
        for q, h in enumerate(host):
            if h is not None:
                tape[q * rows : q * rows + h["moves"].shape[0]] = h["moves"][:, :width]
        tapes = _gather_tensor(mesh, tape) if width else [tape] * mesh.world_size
        out["moves"] = torch.cat([tapes[s // k][(s % k) * rows : (s % k) * rows + hi - lo]
                                  for s, (lo, hi) in enumerate(bounds)])
    if tb:
        bits = torch.zeros((d2, k * rows, lp), dtype=torch.uint8)
        for q, h in enumerate(host):
            if h is not None:
                bits[:, q * rows : q * rows + h["tb"].shape[1]] = h["tb"]
        bitss = _gather_tensor(mesh, bits)
        out["tb"] = torch.cat([bitss[s // k][:, (s % k) * rows : (s % k) * rows + hi - lo]
                               for s, (lo, hi) in enumerate(bounds)], dim=1)
    return out


def _gather_tensor(mesh: PairMesh, t: torch.Tensor) -> list[torch.Tensor]:
    """``all_gather`` of one host tensor of equal shape on every rank."""
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    torch_dist.all_gather(parts, t.contiguous())
    return parts
