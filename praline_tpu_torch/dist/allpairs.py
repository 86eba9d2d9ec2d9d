"""Pair-space sharding of the batched DP.

Counterpart of ``praline_tpu/dist/allpairs.py``.  The JAX package builds a
``shard_map`` for each of its dispatch bodies; the port has one sharding
layer under the batch drivers, ``dist/shards.py``: within each chunk that
``kernels/batch.py`` has already routed and sized, the rows split into the
mesh's contiguous shards, each shard runs the same per-device body, and the
results are gathered on the host (gloo ``all_gather`` across processes).

The JAX package's sharded dispatches and their counterparts here:

- ``sharded_wavefront_dp`` (``:81``) -> :func:`sharded_wavefront_dp`: the
  producer and the whole-row DP over a batch split over the mesh; terminals
  and, with traceback, the traceback bytes gathered;
- ``sharded_indexed_dispatch`` (``:149``) and ``sharded_ckpt_dispatch``
  (``:314``) -> ``align_pairs_batched(mesh=)`` on every route of
  ``choose_route`` ("two_kernel", "fused", "tiled", "checkpointed");
- ``sharded_streamed_dispatch`` (``:274``) and
  ``sharded_chunked_dispatch`` (``:380``) -> none: the port has no streamed
  or chunked route; the fused kernel and the tiled kernel's rows source do
  their job, and run sharded under the same layer;
- ``sharded_indexed_multi_dispatch`` (``:206``) -> none: the port has no
  super-dispatch;
- ``sharded_tracks_dispatch`` (``:457``) -> ``align_tracksets_batched(mesh=)``.

The JAX package refuses host-replay traceback on a mesh across processes
(``praline_tpu/kernels/batch.py:1550-1556``); its ``align_pairs_batched`` sets
``device_replay = traceback`` (``:1109``), so no input reaches that
refusal, and the port, which walks every traceback on the device, accepts
the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.fused_scores import fused_skewed_scores, tier_of
from ..kernels.wavefront import wavefront_dp
from .mesh import PairMesh
from .shards import run_shards


def sharded_wavefront_dp(mesh: PairMesh, cx, inv_x, cy, inv_y, s, lx, ly, gap_series, mode,
                         traceback=False) -> dict[str, torch.Tensor]:
    """The producer and the whole-row DP over a batch (``cx f32[B, Lx, A]``,
    ``inv_x f32[B, Lx]``, ``cy``, ``inv_y``, ``s f32[A, A]``, ``lx``/``ly``
    int32[B]; numpy arrays or host tensors) with the batch split over
    ``mesh``: each shard runs the score producer of its rows' tier and
    ``kernels.wavefront.wavefront_dp`` over the materialized ``hs`` on its
    device.  Returns the terminals of every problem on the host and, with
    ``traceback``, the direction bytes ``tb uint8[D - 2, B, Lp]``, as
    ``kernels.scan.wavefront_dp`` does.  The batch need not divide by the
    shard count.

    This is the JAX function's body (``skewed_pair_scores`` then
    ``wavefront_dp``), so it takes no route of ``batch.choose_route``: the
    fused route never materializes ``hs`` and the checkpointed route keeps
    no traceback bytes.  On the card rows past ``wavefront.MAX_LANES`` lanes
    raise there; ``align_pairs_batched(mesh=)`` routes and sizes them."""
    cx, inv_x, cy, inv_y, s, lx, ly = (torch.as_tensor(np.asarray(a)) for a in
                                       (cx, inv_x, cy, inv_y, s, lx, ly))
    gap_series = tuple(gap_series)
    B, Lx = cx.shape[:2]
    on: dict = {}

    def shard(lo, hi, dev):
        if dev not in on:
            on[dev] = s.to(dev)
        ops = [a[lo:hi].to(dev) for a in (cx, inv_x, cy, inv_y)]
        tier = tier_of(cx[lo:hi].numpy(), cy[lo:hi].numpy(), s.numpy())
        hs = fused_skewed_scores(*ops, on[dev], tier=tier)
        return wavefront_dp(hs, lx[lo:hi].to(dev), ly[lo:hi].to(dev), gap_series, mode,
                            traceback)

    return run_shards(mesh, B, shard, f"{Lx}x{cy.shape[1]}x{B}").gather()
