"""The MSA pipeline: host orchestration over the batched device DP.

Counterpart of ``praline_tpu/msa/pipeline.py:42-374``, stage for stage:
preprofiles, the O(N^2) all-pairs distance stage (scores only), the guide
tree, and the progressive merge one tree level at a time.  Every pairwise
DP goes through ``kernels.batch.align_pairs_batched`` on the caller's
device; profiles, the tree and gap injection are the port's copy of the
JAX package's host code (``praline_tpu_torch.oracle``), so the output is
column-identical to ``oracle_msa``.

The merge stage tries the device-resident walk first
(``msa/device_merge.py``: the node table on the device, every tree level
enqueued, one host copy for the whole walk), as the JAX package does
(``praline_tpu/msa/pipeline.py:237-242``); where it returns None (PAM250's
exactness guard, every column capacity outgrown) the merge walks the
tree one level at a time (:func:`per_level_merge`, the JAX package's own
fallback, ``pipeline.py:245-283``).

Under a pair mesh (``config.mesh_shape`` or ``mesh=``; ``dist/mesh.py``)
every stage's batched call shards its chunks over the mesh, the merge walks
the tree a level at a time (the device walk runs only without a mesh, as
in the JAX package), and only process 0 writes checkpoints.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..dist.mesh import make_pair_mesh, process_index
from ..kernels.batch import ProfileArena, align_pairs_batched
from ..oracle.align import AlignResult
from ..oracle.merge import full_coverage_path, inject_gaps, reorder_to_input
from ..oracle.msa import oracle_msa
from ..oracle.preprofile import project_to_master, star_counts
from ..oracle.profile import compose_profiles, member_profile, node_profile
from ..oracle.tree import build_guide_tree, similarity_from_scores
from ..types import (
    TRACK_ID_PREPROFILE,
    Alignment,
    PralineConfig,
    Profile,
    ScoreMatrix,
    Sequence,
    SequenceTree,
)
from ..util.checkpoint import Checkpoint, run_digest
from ..util.metrics import METRICS, log, maybe_trace
from .device_merge import try_device_merge

# Pairs per resumable distance tile: the O(N^2) stage checkpoints tile by
# tile when a checkpoint directory is set (same tile as the JAX package).
DISTANCE_TILE_PAIRS = 8192


def _wide_batch_pairs(config: PralineConfig) -> int:
    """Chunk width for stages without host-side traceback cost: as wide as
    one distance tile; the device-memory budget still caps long buckets."""
    return max(config.batch_pairs, min(16 * config.batch_pairs, DISTANCE_TILE_PAIRS))


def batched_preprofiles(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    config: PralineConfig,
    *,
    device,
    extra_slaves: dict[int, list[Sequence]] | None = None,
    mesh=None,
) -> list[Sequence]:
    """Attach preprofile tracks; all master-slave DPs in one batched call."""
    mode = config.preprofile_mode
    if mode == "dummy":
        return [s.with_profile(TRACK_ID_PREPROFILE, s.one_hot_profile()) for s in sequences]

    jobs: list[tuple[int, Sequence]] = []  # (master index, slave)
    for i in range(len(sequences)):
        jobs.extend((i, slave) for j, slave in enumerate(sequences) if j != i)
        if extra_slaves and i in extra_slaves:
            jobs.extend((i, hit) for hit in extra_slaves[i])

    # one profile object per sequence: the arena stacks each once
    hot: dict[int, Profile] = {}

    def _hot(seq: Sequence) -> Profile:
        p = hot.get(id(seq))
        if p is None:
            p = hot[id(seq)] = seq.one_hot_profile()
        return p

    pairs = [(_hot(sequences[i]), _hot(slave)) for i, slave in jobs]
    log.info("preprofiles: %d master-slave alignments (%s mode)", len(pairs), mode)
    results: list[AlignResult] = align_pairs_batched(
        pairs, matrix, config.effective_preprofile_gap_series, mode,
        device=device, traceback=True, bucket_sizes=tuple(config.bucket_sizes),
        batch_pairs=_wide_batch_pairs(config), mesh=mesh,
    )
    METRICS.add_pairs(
        "preprofiles", len(pairs), sum(float(a.length) * b.length for a, b in pairs)
    )

    rows: dict[int, list[np.ndarray]] = {i: [] for i in range(len(sequences))}
    toks: dict[int, list[np.ndarray]] = {i: [] for i in range(len(sequences))}
    for (i, slave), res in zip(jobs, results):
        rows[i].append(project_to_master(res, sequences[i].length))
        toks[i].append(slave.tokens)
    return [
        master.with_profile(TRACK_ID_PREPROFILE, star_counts(master, rows[i], toks[i]))
        for i, master in enumerate(sequences)
    ]


def batched_all_pairs(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    config: PralineConfig,
    *,
    device,
    ckpt=None,
    fault_hook=None,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """N x N (score, alignment length) matrices, scores-only DP.

    With a checkpoint each finished tile of :data:`DISTANCE_TILE_PAIRS`
    pairs persists at once, so a failure resumes from the last tile;
    ``fault_hook(tile_id)`` is the failure-injection seam for tests.
    """
    n = len(sequences)
    profiles = [member_profile(s) for s in sequences]
    arena = ProfileArena(matrix.alphabet.size, tuple(config.bucket_sizes),
                         mesh.devices[0] if mesh else device)
    index = [(i, j) for i in range(n) for j in range(i + 1, n)]
    scores = np.zeros((n, n), dtype=np.float64)
    lengths = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        lengths[i, i] = max(1, sequences[i].length)

    # tiles exist for resume; without a checkpoint the stage is one call
    tile_pairs = DISTANCE_TILE_PAIRS
    if ckpt is None and fault_hook is None:
        tile_pairs = max(len(index), 1)
    for t in range(0, len(index), tile_pairs):
        tile_id = t // tile_pairs
        tile = index[t : t + tile_pairs]
        loaded = ckpt.load_distance_tile(tile_id) if ckpt else None
        if loaded is not None:
            tile_scores, tile_lengths = loaded
        else:
            if fault_hook is not None:
                fault_hook(tile_id)
            results = align_pairs_batched(
                [(profiles[i], profiles[j]) for i, j in tile],
                matrix, config.gap_series, config.distance_mode,
                device=device, traceback=False,
                bucket_sizes=tuple(config.bucket_sizes),
                batch_pairs=_wide_batch_pairs(config), arena=arena, mesh=mesh,
            )
            tile_scores = np.array([r.score for r in results])
            tile_lengths = np.array([r.length for r in results])
            if ckpt:
                ckpt.save_distance_tile(tile_id, tile_scores, tile_lengths)
        ii = np.fromiter((i for i, _ in tile), np.int64, len(tile))
        jj = np.fromiter((j for _, j in tile), np.int64, len(tile))
        scores[ii, jj] = scores[jj, ii] = np.asarray(tile_scores, np.float64)
        lengths[ii, jj] = lengths[jj, ii] = np.asarray(tile_lengths, np.int64)
        log.info(
            "all-pairs: %d/%d pairs done%s", min(t + tile_pairs, len(index)),
            len(index), " (from checkpoint)" if loaded is not None else "",
        )
    if ckpt:
        ckpt.save_distances(scores, lengths)
        ckpt.clear_distance_tiles()
    return scores, lengths


def _merge_levels(tree: SequenceTree) -> list[list[int]]:
    """Join indices grouped by depth; the joins of one level are independent."""
    n = tree.num_leaves
    depth = {i: 0 for i in range(n)}
    levels: dict[int, list[int]] = {}
    for k, (l, r) in enumerate(tree.joins):
        d = 1 + max(depth[l], depth[r])
        depth[n + k] = d
        levels.setdefault(d, []).append(k)
    return [levels[d] for d in sorted(levels)]


def batched_progressive_merge(
    sequences: list[Sequence],
    tree: SequenceTree,
    matrix: ScoreMatrix,
    config: PralineConfig,
    *,
    device,
    mesh=None,
) -> Alignment:
    """The merge stage: without a mesh, the device-resident walk where it
    takes the input (``device_merge.try_device_merge``), else (and on a
    mesh, sharded) :func:`per_level_merge`.  ``METRICS.notes["merge_walk"]``
    says which ran."""
    if mesh is None:
        merged = try_device_merge(sequences, tree, matrix, config, device=device)
        if merged is not None:
            return merged
    return per_level_merge(sequences, tree, matrix, config, device=device, mesh=mesh)


def per_level_merge(
    sequences: list[Sequence],
    tree: SequenceTree,
    matrix: ScoreMatrix,
    config: PralineConfig,
    *,
    device,
    mesh=None,
) -> Alignment:
    """Walk the guide tree one level at a time: each level's joins are one
    batched profile-profile traceback call (sharded over ``mesh``)."""
    METRICS.note("merge_walk", "per-level")
    nodes: dict[int, Alignment] = {i: Alignment.single(s) for i, s in enumerate(sequences)}
    profiles: dict[int, Profile] = {i: node_profile(nodes[i]) for i in range(len(sequences))}
    n = tree.num_leaves
    levels = _merge_levels(tree)
    for li, level in enumerate(levels):
        log.info("merge: level %d/%d (%d joins)", li + 1, len(levels), len(level))
        pairs = [(profiles[tree.joins[k][0]], profiles[tree.joins[k][1]]) for k in level]
        results = align_pairs_batched(
            pairs, matrix, config.gap_series, config.merge_mode,
            device=device, traceback=True, bucket_sizes=tuple(config.bucket_sizes),
            batch_pairs=config.batch_pairs, mesh=mesh,
        )
        METRICS.add_pairs(
            "merge", len(pairs), sum(float(a.length) * b.length for a, b in pairs)
        )
        for k, res in zip(level, results):
            l, r = tree.joins[k]
            left, right = nodes.pop(l), nodes.pop(r)
            pl, pr = profiles.pop(l), profiles.pop(r)
            cols_x, cols_y = full_coverage_path(res, left.num_columns, right.num_columns)
            nodes[n + k] = Alignment(
                left.members + right.members,
                inject_gaps(left.rows, right.rows, cols_x, cols_y),
            )
            profiles[n + k] = compose_profiles(
                pl, pr, left.num_members, right.num_members, cols_x, cols_y
            )
    return reorder_to_input(nodes[tree.root], sequences)


def msa_align(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    config: PralineConfig | None = None,
    *,
    device="cuda",
    extra_slaves: dict[int, list[Sequence]] | None = None,
    mesh=None,
    fault_hook=None,
    on_tree=None,
) -> Alignment:
    """Full progressive MSA on ``device`` (``"cuda"`` or ``"cpu"``).

    ``device="cuda"`` raises when no card is visible: the CPU runs only
    when asked for.  ``extra_slaves`` (homology hits, ``msa/homology.py``)
    join the preprofiles.  ``mesh`` (a ``dist.PairMesh``; by default one of
    ``config.mesh_shape`` shards, where set) shards every stage; on a mesh
    across processes every process makes this call with the same inputs.  ``config.backend == "oracle"`` runs the NumPy
    reference pipeline; ``"auto"`` runs the port; the JAX backends
    (``"xla"``, ``"pallas"``) belong to ``praline_tpu`` and raise here.
    ``on_tree(tree)`` is called once the guide tree exists.
    """
    config = config or PralineConfig()
    if config.backend in ("xla", "pallas"):
        raise ValueError(
            f"backend {config.backend!r} is the JAX package's; the PyTorch port "
            "runs backend 'auto' (or 'oracle')"
        )
    if not sequences:
        raise ValueError("no sequences")
    if len(sequences) == 1:
        return Alignment.single(sequences[0])
    if config.backend == "oracle":
        return oracle_msa(sequences, matrix, config, extra_slaves=extra_slaves, on_tree=on_tree)

    dev = resolve_device(device)
    if mesh is None and config.mesh_shape:
        mesh = make_pair_mesh(int(np.prod(config.mesh_shape)), device=dev.type)
    if mesh is not None:
        dev = mesh.devices[0]
    ckpt = None
    if config.checkpoint_dir:
        # every process reads the shared directory, only process 0 writes
        # (the artifacts are the same on every process)
        ckpt = Checkpoint(
            config.checkpoint_dir, run_digest(sequences, config, extra_slaves=extra_slaves),
            writer=process_index() == 0,
        )
    METRICS.reset()
    with maybe_trace("msa_align"):
        with METRICS.timed("preprofiles"):
            seqs = ckpt.load_preprofiles(sequences) if ckpt else None
            if seqs is None:
                seqs = batched_preprofiles(
                    sequences, matrix, config, device=dev, extra_slaves=extra_slaves, mesh=mesh
                )
                if ckpt and config.preprofile_mode != "dummy":
                    ckpt.save_preprofiles(seqs)

        with METRICS.timed("all_pairs"):
            loaded = ckpt.load_distances() if ckpt else None
            if loaded is None:
                scores, lengths = batched_all_pairs(
                    seqs, matrix, config, device=dev, ckpt=ckpt, fault_hook=fault_hook,
                    mesh=mesh,
                )
                n = len(seqs)
                lens = np.array([s.length for s in seqs], dtype=np.float64)
                cells = float((lens.sum() ** 2 - (lens**2).sum()) / 2)
                METRICS.add_pairs("all_pairs", n * (n - 1) // 2, cells)
            else:
                scores, lengths = loaded

        with METRICS.timed("guide_tree"):
            tree = ckpt.load_tree() if ckpt else None
            if tree is None:
                sim = similarity_from_scores(scores, lengths, config.score_normalization)
                tree = build_guide_tree(sim, config.linkage)
                if ckpt:
                    ckpt.save_tree(tree)
            if on_tree is not None:
                on_tree(tree)

        with METRICS.timed("merge"), maybe_trace("merge"):
            result = batched_progressive_merge(seqs, tree, matrix, config, device=dev,
                                               mesh=mesh)
    METRICS.log_summary()
    return result
