"""Tile-resumable checkpoints for the expensive pipeline stages.

The reference has no checkpointing (rerun from scratch; SURVEY.md §6).  The
TPU build persists, per run: (a) preprofile tracks, (b) the O(N^2) distance
matrices, (c) the guide tree — as ``.npz``/JSON artifacts keyed by a digest
of the inputs + config, so ``--resume`` skips completed stages and a
multi-host failure restarts from the last finished artifact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np

from ..types import PralineConfig, Profile, Sequence, SequenceTree, TRACK_ID_PREPROFILE


def run_digest(
    sequences: list[Sequence],
    config: PralineConfig,
    extra_slaves: dict[int, list[Sequence]] | None = None,
) -> str:
    """Digest of inputs + semantics-affecting config, guarding stale resume.

    ``extra_slaves`` (homology hits, SURVEY.md §8.5) shape the preprofiles
    that ``preprofiles.npz`` caches, so their CONTENT is part of the run
    identity: re-running against a different BLAST database (or the same
    database after it drifted) must invalidate the checkpoint rather than
    silently reuse stale preprofiles.  Hashing the resolved hits — not the
    database path — makes the guard content-based: a renamed-but-identical
    DB resumes, an in-place-mutated one does not.
    """
    h = hashlib.sha256()
    for s in sequences:
        h.update(s.name.encode())
        h.update(s.tokens.tobytes())
    if extra_slaves:
        for i in sorted(extra_slaves):
            h.update(b"extra:%d" % i)
            for hit in extra_slaves[i]:
                h.update(hit.name.encode())
                h.update(hit.tokens.tobytes())
    cfg = dataclasses.asdict(config)
    # Exclude knobs that don't change alignment semantics: batching/device
    # choices and output formatting.
    for key in (
        "bucket_sizes",
        "batch_pairs",
        "backend",
        "mesh_shape",
        "checkpoint_dir",
        "output_format",
        "fasta_wrap",
    ):
        cfg.pop(key, None)
    h.update(json.dumps(cfg, sort_keys=True, default=str).encode())
    return h.hexdigest()[:16]


class Checkpoint:
    def __init__(self, directory: str | Path, digest: str,
                 writer: bool = True) -> None:
        """``writer=False`` makes every ``save_*`` a no-op: under
        multi-process SPMD all hosts share one checkpoint dir, every host
        READS (artifacts are identical either way — the pipeline is
        deterministic), and only process 0 WRITES (SURVEY.md §9 hard
        part 5)."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.digest = digest
        self.writer = writer
        meta = self.dir / "meta.json"
        if meta.exists():
            old = json.loads(meta.read_text())
            if old.get("digest") != digest:
                raise ValueError(
                    f"checkpoint dir {self.dir} belongs to a different run "
                    f"(digest {old.get('digest')} != {digest}); use a fresh dir"
                )
        elif self.writer:
            # Only the writer host creates meta.json, and atomically — a
            # concurrent reader must never see a partial file (ADVICE r3).
            self._write_text_atomic("meta.json", json.dumps({"digest": digest}))

    def _write_text_atomic(self, name: str, text: str) -> None:
        # Same tmp + rename discipline as _savez_atomic: concurrent readers
        # (other hosts resuming) see either the old file or the new one.
        tmp = self.dir / f".{name}.tmp"
        tmp.write_text(text)
        tmp.replace(self.dir / name)

    # -- preprofiles ------------------------------------------------------
    def save_preprofiles(self, sequences: list[Sequence]) -> None:
        if not self.writer:
            return
        arrays = {}
        for i, s in enumerate(sequences):
            prof = s.profiles[TRACK_ID_PREPROFILE]
            arrays[f"counts_{i}"] = prof.counts
            arrays[f"gaps_{i}"] = prof.gaps
        self._savez_atomic("preprofiles.npz", **arrays)

    def _savez_atomic(self, name: str, **arrays) -> None:
        # tmp + rename: a concurrent reader (another host resuming) never
        # sees a partial npz.
        tmp = self.dir / f".{name}.tmp"
        with open(tmp, "wb") as f:  # file handle: savez must not append .npz
            np.savez_compressed(f, **arrays)
        tmp.replace(self.dir / name)

    def load_preprofiles(self, sequences: list[Sequence]) -> list[Sequence] | None:
        path = self.dir / "preprofiles.npz"
        if not path.exists():
            return None
        data = np.load(path)
        out = []
        for i, s in enumerate(sequences):
            prof = Profile(data[f"counts_{i}"], data[f"gaps_{i}"], s.alphabet)
            out.append(s.with_profile(TRACK_ID_PREPROFILE, prof))
        return out

    # -- distance stage ---------------------------------------------------
    def save_distances(self, scores: np.ndarray, lengths: np.ndarray) -> None:
        if not self.writer:
            return
        self._savez_atomic("distances.npz", scores=scores, lengths=lengths)

    def load_distances(self) -> tuple[np.ndarray, np.ndarray] | None:
        path = self.dir / "distances.npz"
        if not path.exists():
            return None
        data = np.load(path)
        return data["scores"], data["lengths"]

    # -- distance tiles (mid-stage resume; SURVEY.md §6 checkpoint row) ----
    def save_distance_tile(
        self, tile_id: int, scores: np.ndarray, lengths: np.ndarray
    ) -> None:
        """Persist one completed chunk of the O(N^2) stage.  Tiles write to
        disjoint files, so completion order (and multi-host ownership) never
        affects the merged matrix."""
        if not self.writer:
            return
        tmp = self.dir / f".tile_{tile_id}.npz.tmp"
        with open(tmp, "wb") as f:  # file handle: savez must not append .npz
            np.savez_compressed(f, scores=scores, lengths=lengths)
        tmp.replace(self.dir / f"tile_{tile_id}.npz")

    def load_distance_tile(self, tile_id: int) -> tuple[np.ndarray, np.ndarray] | None:
        path = self.dir / f"tile_{tile_id}.npz"
        if not path.exists():
            return None
        data = np.load(path)
        return data["scores"], data["lengths"]

    def clear_distance_tiles(self) -> None:
        for p in self.dir.glob("tile_*.npz"):
            p.unlink()

    # -- guide tree -------------------------------------------------------
    def save_tree(self, tree: SequenceTree) -> None:
        if not self.writer:
            return
        self._write_text_atomic(
            "tree.json",
            json.dumps({"num_leaves": tree.num_leaves, "joins": list(tree.joins)}),
        )

    def load_tree(self) -> SequenceTree | None:
        path = self.dir / "tree.json"
        if not path.exists():
            return None
        data = json.loads(path.read_text())
        return SequenceTree(data["num_leaves"], tuple(tuple(j) for j in data["joins"]))
