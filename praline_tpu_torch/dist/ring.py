"""Ring-parallel single alignment: one problem's lanes sharded over a mesh.

Counterpart of ``praline_tpu/dist/ring.py`` (``ring_wavefront_dp`` and the
superstepped and checkpointed forms of ``praline_tpu/kernels/scan.py``'s
``_wavefront``, ``:668-902``), for one alignment too big for one device.
The DP's lane (x) axis is cut into ``n = mesh.shards`` blocks of ``Lpn =
ceil((Lx + 1) / n)`` lanes: shard p owns global lanes ``p Lpn ..``
(:func:`~..kernels.scan.ring_rows`, the y side whole on every shard), and
runs the DP over them one chunk of ``interval`` = K diagonals at a time.

The schedule is the JAX package's: in superstep s, shard p runs chunk
``s - p`` (diagonals 2 + (s - p) K ..), so shard p runs a chunk right after
shard p - 1 ran it; fill and drain supersteps still exchange but launch
nothing.  A chunk on one shard is one launch of
``kernels/tiled_dp.py::wavefront_dp_tiled_ring`` (the lane-tiled DP, K6,
walking the chunk on the shard's lanes from its stored carries; on CPU
tensors its plain version ``kernels/scan.py::ring_superstep_plain``).  The
left edge of a shard's first lane before each step of the chunk (its
"heads") is the left shard's last lane before the same step (its "tails",
``f32[K, NX, B]``), recorded one superstep earlier; after every superstep
the tails move one shard to the right: by a device copy within a process,
and between processes as host tensors by ``torch.distributed`` ``isend`` /
``irecv`` (gloo), both posted before either waits, under the process
group's timeout, so a dead neighbour raises instead of hanging.

Each shard keeps its own terminal candidate (the cells it owns); at the end
they are gathered (gloo ``all_gather`` across processes) and merged by the
modes' lexicographic rule (``praline_tpu/kernels/scan.py:1024-1049``), in
exact integers.  With ``traceback`` each shard writes its lanes' bytes and
the host concatenates them into the global ``(D - 2, B, Lp_pad)`` layout.
With ``ckpt_interval`` (the checkpointed traceback): the forward
supersteps keep each shard's carries at the first chunk of every block of
R = ``ckpt_interval`` rounded up to whole chunks; then for each block, last
first, the block runs again as a pipeline of ``R / K + n - 1`` supersteps
from those carries, writing its bytes into a ``u8[R, B, Lpn]`` block buffer,
the blocks' bytes are gathered across shards and
``kernels/replay.py::replay_block`` walks them on every process (replicated,
as the JAX package walks on every device), appending to the move tape.  The
JAX package also keeps the heads a shard takes at a block's first chunk;
in the mini pipeline a shard's first chunk takes the heads its left shard
recorded one superstep earlier, so they are not kept.  Memory a shard:
O(R Lp + D / R NS Lpn).

Each launch, exchange, gather and walk runs under a ``ring:...`` span
(``util/metrics.py::span``: a profiler range wherever a torch profiler is
recording), its host seconds added to ``METRICS.stages`` (``METRICS.timed``
of the same name); inside the exchange across processes,
``ring:wait`` is the wait for this rank's launches before the host copy.
"""

from __future__ import annotations

import torch
import torch.distributed as torch_dist

from ..kernels.replay import replay_block, walk_state
from ..kernels.scan import (
    CANDIDATE, MODES, edge_values, ring_candidate, ring_carries, ring_rows, unpack_candidate,
)
from ..kernels.tiled_dp import wavefront_dp_tiled_ring
from ..util.metrics import METRICS, span
from .mesh import PairMesh

DEFAULT_INTERVAL = 32  # diagonals a superstep (the JAX package's default)


def beats(a: tuple, b: tuple, local: bool) -> bool:
    """Candidate ``a`` = (score, i, j) over ``b`` by the modes' rule: larger
    score, then smaller (i, j) in local mode, larger elsewhere."""
    if a[0] != b[0]:
        return a[0] > b[0]
    return a[1:] < b[1:] if local else a[1:] > b[1:]


def merge_candidates(cands: list[torch.Tensor], mode: str) -> dict:
    """The terminals of a batch from every shard's candidate ``f32[5, B]``
    (host tensors, in shard order): for each problem the winner of
    :func:`beats` over the shards (the first of equals), whose length and
    state code ride along."""
    unpacked = [unpack_candidate(c) for c in cands]
    rows = [[(float(u["score"][b]), int(u["ti"][b]), int(u["tj"][b]))
             for b in range(cands[0].shape[1])] for u in unpacked]
    out = {k: unpacked[0][k].clone() for k in CANDIDATE}
    for b in range(cands[0].shape[1]):
        win = 0
        for q in range(1, len(cands)):
            if beats(rows[q][b], rows[win][b], mode == "local"):
                win = q
        for k in CANDIDATE:
            out[k][b] = unpacked[win][k][b]
    return out


class _Shard:
    """One shard's state on its device: rows, carries, candidate, heads,
    tails."""

    def __init__(self, rows, carries, cand, K, nx):
        dev = rows.device
        self.rows, self.carries, self.cand = rows, carries, cand
        self.heads = torch.zeros((K, nx, rows.B), dtype=torch.float32, device=dev)
        self.tails = torch.zeros_like(self.heads)


class _Ring:
    """The ring over ``mesh``: the shards this process drives and the
    exchange between supersteps."""

    def __init__(self, mesh: PairMesh, ops, lx, ly, gap_series, mode, K):
        cx, inv_x, cy, inv_y, s = ops
        B, Lx, _ = cx.shape
        self.mesh, self.gap_series, self.mode, self.K = mesh, gap_series, mode, K
        self.n = mesh.shards
        self.Lpn = -(-(Lx + 1) // self.n)
        self.D = Lx + cy.shape[1] + 1
        self.nchunks = -(-(self.D - 2) // K)
        nx = edge_values(len(gap_series))
        self.shards = []
        for p, dev in zip(mesh.local_shards, mesh.devices):
            rows = ring_rows(cx, inv_x, cy, inv_y, s, p * self.Lpn, self.Lpn, dev)
            self.shards.append(_Shard(rows, ring_carries(rows, gap_series, mode),
                                      ring_candidate(lx, ly, gap_series, mode).to(dev), K, nx))
        self.lx = [lx.to(sh.rows.device) for sh in self.shards]
        self.ly = [ly.to(sh.rows.device) for sh in self.shards]
        self.recv = torch.zeros((K, nx, B), dtype=torch.float32)

    def launch(self, q: int, c: int, tb=None, tb_row0: int = 0) -> None:
        """Chunk ``c`` on local shard ``q``, writing its bytes where ``tb``
        is given (the carries track the stay bits either way)."""
        sh, p = self.shards[q], self.mesh.first_shard + q
        name = f"ring:launch:shard{p}/{self.n}"
        with span(name), METRICS.timed(name):
            wavefront_dp_tiled_ring(
                sh.rows, self.lx[q], self.ly[q], self.gap_series, self.mode, tb is not None,
                2 + c * self.K, self.K, sh.carries, sh.heads if p > 0 else None, sh.tails,
                sh.cand, tb=tb, tb_row0=tb_row0)

    def superstep(self, step: int, chunks: range, tb=None, tb_row0: int = 0) -> None:
        """Superstep ``step``: local shard p runs chunk ``chunks[step - p]``
        where that is in range, then the tails move one shard right."""
        for q in range(len(self.shards)):
            at = step - (self.mesh.first_shard + q)
            if 0 <= at < len(chunks):
                self.launch(q, chunks[at], None if tb is None else tb[q], tb_row0)
        self.exchange()

    def exchange(self) -> None:
        """The tails of this superstep to the right shard's heads."""
        with span("ring:exchange"), METRICS.timed("ring:exchange"):
            for a, b in zip(self.shards, self.shards[1:]):
                b.heads.copy_(a.tails)
            mesh = self.mesh
            if not mesh.spans_processes:
                return
            if self.shards[-1].rows.device.type == "cuda":
                # this rank's launches, before the host copy
                with span("ring:wait"), METRICS.timed("ring:wait"):
                    torch.cuda.current_stream(self.shards[-1].rows.device).synchronize()
            works = []
            if mesh.rank + 1 < mesh.world_size:
                works.append(torch_dist.isend(self.shards[-1].tails.cpu(), mesh.rank + 1))
            if mesh.rank > 0:
                works.append(torch_dist.irecv(self.recv, mesh.rank - 1))
            for w in works:
                w.wait()
            if mesh.rank > 0:
                self.shards[0].heads.copy_(self.recv)

    def gather_lanes(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's ``[..., Lpn]`` tensor joined along the last axis in
        shard order, on the host (gloo ``all_gather`` across processes)."""
        with span("ring:gather"), METRICS.timed("ring:gather"):
            mine = torch.cat([t.cpu() for t in parts], dim=-1)
            if not self.mesh.spans_processes:
                return mine
            every = [torch.empty_like(mine) for _ in range(self.mesh.world_size)]
            torch_dist.all_gather(every, mine)
            return torch.cat(every, dim=-1)

    def terminals(self) -> dict:
        """Every shard's candidate, merged."""
        with span("ring:gather"), METRICS.timed("ring:gather"):
            mine = torch.stack([sh.cand.cpu() for sh in self.shards])
            if self.mesh.spans_processes:
                every = [torch.empty_like(mine) for _ in range(self.mesh.world_size)]
                torch_dist.all_gather(every, mine)
                mine = torch.cat(every)
        return merge_candidates(list(mine), self.mode)


def ring_wavefront_dp(mesh: PairMesh, cx, inv_x, cy, inv_y, s, lx, ly, gap_series=(11, 1),
                      mode="global", traceback=False, interval=None, ckpt_interval=None):
    """Run B (usually 1) oversized pairwise DPs with lanes sharded over
    ``mesh`` (``make_pair_mesh``; across processes after
    ``initialize_distributed``, every rank calling with the same inputs).
    ``cx f32[B, Lx, A]``, ``inv_x f32[B, Lx]``, ``cy f32[B, Ly, A]``,
    ``inv_y f32[B, Ly]``, ``s f32[A, A]``, ``lx``/``ly int32[B]``, numpy
    arrays or tensors.  Same terminal contract as ``kernels.scan.
    wavefront_dp``, on the host: ``score``, ``length``, ``ti``, ``tj``,
    ``tcode``; with ``traceback``, ``tb uint8[D - 2, B, Lp_pad]`` in the
    global layout (lanes past Lx + 1 are the last shards' padding).

    ``interval``: diagonals a superstep (default 32; 1 or less: one
    exchange a diagonal).  ``ckpt_interval``: with ``traceback`` and ``interval > 1``,
    the checkpointed traceback, returning ``moves uint8[B, S]`` and
    ``nmoves int32[B]`` (``kernels/replay.py``'s move-tape contract, S =
    the blocks times R + 1) instead of ``tb``.  Raises ``ValueError``
    where the JAX function does."""
    gap_series = tuple(gap_series)
    if len(gap_series) > 15:
        raise ValueError("gap series deeper than 15 levels not supported")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    # an interval of 1 or less is the per-diagonal exchange, as in the JAX package
    K = max(1, DEFAULT_INTERVAL if interval is None else int(interval))
    ops = [torch.as_tensor(a).to("cpu", torch.float32) for a in (cx, inv_x, cy, inv_y, s)]
    lx, ly = (torch.as_tensor(a).to("cpu", torch.int32) for a in (lx, ly))
    B, Lx, _ = ops[0].shape
    Ly = ops[2].shape[1]
    if K > 1 and Lx + Ly + 1 >= 1 << 24:
        raise ValueError("superstepped ring terminal merge supports Lx + Ly < 2^24; use "
                         "interval=1 beyond")
    if ckpt_interval is not None and (K <= 1 or not traceback):
        raise ValueError("ring checkpointed traceback requires the superstepped exchange "
                         "(interval > 1) and traceback=True")
    ring = _Ring(mesh, ops, lx, ly, gap_series, mode, K)
    if ckpt_interval is not None:
        return _checkpointed(ring, int(ckpt_interval))
    D, Lpn = ring.D, ring.Lpn
    chunks = range(ring.nchunks)
    tb = None
    if traceback:
        tb = [torch.empty((D - 2, B, Lpn), dtype=torch.uint8, device=sh.rows.device)
              for sh in ring.shards]
    for step in range(ring.nchunks + ring.n - 1):
        ring.superstep(step, chunks, tb)
    out = ring.terminals()
    if traceback:
        out["tb"] = ring.gather_lanes(tb)
    return out


def _checkpointed(ring: _Ring, ckpt_interval: int) -> dict:
    """The checkpointed ring traceback (``praline_tpu/kernels/scan.py:
    732-902``): forward supersteps keeping each shard's carries at every
    block's first chunk, then per block, last first, its mini pipeline into
    a block buffer, the gather of its bytes and the block walk."""
    K, n = ring.K, ring.n
    per_blk = -(-ckpt_interval // K)
    R = per_blk * K
    nblocks = -(-ring.nchunks // per_blk)
    snaps = [[None] * nblocks for _ in ring.shards]
    for step in range(ring.nchunks + n - 1):
        for q, sh in enumerate(ring.shards):
            c = step - (ring.mesh.first_shard + q)
            if 0 <= c < ring.nchunks and c % per_blk == 0:
                snaps[q][c // per_blk] = sh.carries.clone()
        ring.superstep(step, range(ring.nchunks))
    out = ring.terminals()
    k = len(ring.gap_series)
    walk_dev = ring.shards[0].rows.device
    state = walk_state(out["ti"], out["tj"], out["tcode"], k).to(walk_dev)
    B = out["score"].shape[0]
    moves = torch.zeros((B, nblocks * (R + 1)), dtype=torch.uint8, device=walk_dev)
    blocks = [torch.empty((R, B, ring.Lpn), dtype=torch.uint8, device=sh.rows.device)
              for sh in ring.shards]
    for blk in range(nblocks - 1, -1, -1):
        chunks = range(blk * per_blk, min((blk + 1) * per_blk, ring.nchunks))
        for q, sh in enumerate(ring.shards):
            sh.carries.copy_(snaps[q][blk])
        for step in range(len(chunks) + n - 1):
            ring.superstep(step, chunks, blocks, blk * R)
        bits = ring.gather_lanes(blocks).to(walk_dev)
        with span("ring:walk"), METRICS.timed("ring:walk"):
            replay_block(bits, state, moves, blk, ring.gap_series, ring.mode)
    out["moves"] = moves.cpu()
    out["nmoves"] = state[5].cpu()
    return out
