"""Two processes on ``torch.distributed`` (gloo, the CPU): a pair mesh across
both ranks (``praline_tpu_torch/dist``).

Each test starts this file twice as a rank (``python
tests/test_torch_multiprocess.py RANK PORT DIR TASK``), on a free port,
each with a 60 s timeout.  Task ``run``: ``align_pairs_batched`` in scores
and traceback modes and the full ``msa_align`` with a shared checkpoint
directory, on a mesh of one CPU shard a rank; both ranks' results must
equal the JAX package's single-process results (its
``align_pairs_batched`` on the same numpy-built profiles, and the
``family10`` ``ppglobal`` golden, which ``tests/e2e/test_goldens.py``
holds the JAX package to), and only rank 0 may write checkpoint files.
Task ``fail``: rank 1 raises before its first collective; rank 0 must
then fail at the process group's timeout instead of hanging.  Task
``ring``: ``ring_wavefront_dp`` with one shard a rank (the lanes split
across the processes, the edges exchanged by gloo ``isend``/``irecv``) at
interval 32 with traceback and checkpointed at interval 8; both ranks'
terminals, bytes and move tapes must equal the JAX ring's in one process.
Task ``ring-fail``: rank 0 raises before the ring; rank 1, waiting for its
left neighbour's edges, must fail instead of hanging.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TESTDATA = ROOT / "testdata"
RANK_TIMEOUT_S = 60
COLLECTIVE_TIMEOUT_S = 20
A = 23


def pair_arrays(seed=3, n=9):
    """Counts of ``n`` ragged profiles (numpy) and the pairs to align."""
    rng = np.random.default_rng(seed)
    counts = []
    for k in range(n):
        L = int(rng.integers(5, 50))
        c = rng.integers(0, 3, size=(L, A)).astype(np.float32)
        c[:, 0] += 1
        counts.append(c)
    pairs = [(i, j) for i in range(n) for j in range(n) if (i * 5 + j) % 3 == 0]
    return counts, pairs


RING_RUNS = {"superstep": dict(gap_series=(11, 1), mode="semiglobal", traceback=True,
                               interval=32),
             "checkpointed": dict(gap_series=(13, 7, 1), mode="local", traceback=True,
                                  interval=8, ckpt_interval=24)}


def ring_arrays(B=2, Lx=70, Ly=60, A=A):
    """One seeded batch of count profiles for the ring (numpy)."""
    rng = np.random.default_rng(12)
    cx = (rng.integers(0, 3, size=(B, Lx, A)) + (np.arange(A) == 0)).astype(np.float32)
    cy = (rng.integers(0, 3, size=(B, Ly, A)) + (np.arange(A) == 0)).astype(np.float32)
    ivx = (1.0 / np.maximum(cx.sum(-1), 1)).astype(np.float32)
    ivy = (1.0 / np.maximum(cy.sum(-1), 1)).astype(np.float32)
    lx = np.array([Lx, Lx - 7], np.int32)
    ly = np.array([Ly - 3, Ly], np.int32)
    return cx, ivx, cy, ivy, lx, ly


def ring_main(out_dir: Path, rank: int) -> None:
    """Task ``ring`` in a rank whose process group is up."""
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.dist import make_pair_mesh, ring_wavefront_dp

    mesh = make_pair_mesh(device="cpu")
    cx, ivx, cy, ivy, lx, ly = ring_arrays()
    s = builtin_score_matrix("blosum62").as_f32()
    out = {}
    for name, kw in RING_RUNS.items():
        res = ring_wavefront_dp(mesh, cx, ivx, cy, ivy, s, lx, ly, **kw)
        out[name] = {k: (v.view(torch.int32) if v.dtype == torch.float32 else v).tolist()
                     for k, v in res.items()}
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))


def result_arrays(results, traceback):
    """The fields of a result list as plain lists (to compare and to JSON)."""
    if traceback:
        return [[r.score, list(r.x_range), list(r.y_range), r.cols_x.tolist(), r.cols_y.tolist()]
                for r in results]
    return [[r.score, r.length, r.ti, r.tj] for r in results]


def rank_main(rank: int, port: int, out_dir: Path, task: str) -> None:
    import torch

    from praline_tpu_torch import ALPHABET_AA, PralineConfig, builtin_score_matrix
    from praline_tpu_torch.convert import profile_from_arrays
    from praline_tpu_torch.dist import initialize_distributed, make_pair_mesh, shutdown_distributed
    from praline_tpu_torch.io import format_alignment_fasta, load_sequence_fasta
    from praline_tpu_torch.kernels import align_pairs_batched
    from praline_tpu_torch.msa import msa_align

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", 2, rank,
                           timeout_s=5 if task.endswith("fail") else COLLECTIVE_TIMEOUT_S)
    try:
        if task == "fail" and rank == 1:
            raise RuntimeError("rank 1 fails before its first collective")
        if task == "ring-fail" and rank == 0:
            raise RuntimeError("rank 0 fails before the ring")
        if task.startswith("ring"):
            ring_main(out_dir, rank)
            return
        mesh = make_pair_mesh(device="cpu")
        m = builtin_score_matrix("blosum62")
        counts, idx = pair_arrays()
        profs = [profile_from_arrays(c, np.zeros(len(c), np.float32), ALPHABET_AA.symbols)
                 for c in counts]
        pairs = [(profs[i], profs[j]) for i, j in idx]
        out = {}
        for mode, traceback in (("global", False), ("local", True)):
            res = align_pairs_batched(pairs, m, (11, 1), mode, device="cpu", traceback=traceback,
                                      bucket_sizes=(31, 63), batch_pairs=4, mesh=mesh)
            out[mode] = result_arrays(res, traceback)
        writes = []
        replace = Path.replace

        def counted_replace(self, target):
            writes.append(str(target))
            return replace(self, target)

        Path.replace = counted_replace
        seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
        cfg = PralineConfig(preprofile_mode="global", mesh_shape=(2,),
                            checkpoint_dir=str(out_dir / "ck"))
        out["fasta"] = format_alignment_fasta(msa_align(seqs, m, cfg, device="cpu"))
        Path.replace = replace
        out["writes"] = writes
        (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        shutdown_distributed()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, task):
    """Both ranks of ``task``; their exit codes and output."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(port), str(tmp_path),
                               task], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], logs


def test_two_ranks_match_the_single_process_run(tmp_path):
    from praline_tpu import ALPHABET_AA as JAX_AA
    from praline_tpu import builtin_score_matrix as jax_matrix
    from praline_tpu.kernels import align_pairs_batched as jax_align_pairs
    from praline_tpu.types import Profile as JaxProfile

    rcs, logs = run_ranks(tmp_path, "run")
    assert rcs == [0, 0], "\n".join(log[-3000:] for log in logs)
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    counts, idx = pair_arrays()
    profs = [JaxProfile(c, np.zeros(len(c), np.float32), JAX_AA) for c in counts]
    pairs = [(profs[i], profs[j]) for i, j in idx]
    for mode, traceback in (("global", False), ("local", True)):
        want = result_arrays(jax_align_pairs(pairs, jax_matrix("blosum62"), (11, 1), mode,
                                             traceback=traceback, bucket_sizes=(31, 63),
                                             backend="xla"), traceback)
        assert outs[0][mode] == outs[1][mode] == json.loads(json.dumps(want)), mode
    golden = (TESTDATA / "family10.ppglobal.golden.fasta").read_text()
    assert outs[0]["fasta"] == outs[1]["fasta"] == golden
    ck = str(tmp_path / "ck")
    assert outs[0]["writes"] and all(w.startswith(ck) for w in outs[0]["writes"])
    assert outs[1]["writes"] == []
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "distances.npz", "meta.json", "preprofiles.npz", "tree.json"]


def test_two_ranks_ring_matches_jax(tmp_path):
    """The ring across two processes (one shard each) equals the JAX ring
    on two simulated devices in this process: terminals (floats by their
    bits), every traceback byte of the global layout, the checkpointed
    walk's move count and tape."""
    from praline_tpu import builtin_score_matrix as jax_matrix
    from praline_tpu.dist import make_pair_mesh as jax_mesh
    from praline_tpu.dist.ring import ring_wavefront_dp as jax_ring

    rcs, logs = run_ranks(tmp_path, "ring")
    assert rcs == [0, 0], "\n".join(log[-3000:] for log in logs)
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    cx, ivx, cy, ivy, lx, ly = ring_arrays()
    s = np.asarray(jax_matrix("blosum62").as_f32())
    for name, kw in RING_RUNS.items():
        want = {k: np.asarray(v) for k, v in
                jax_ring(jax_mesh(2), cx, ivx, cy, ivy, s, lx, ly, **kw).items()}
        for out in outs:
            got = out[name]
            assert set(got) == set(want), name
            for key, w in want.items():
                g = np.asarray(got[key])
                if w.dtype == np.float32:
                    w = w.view(np.int32)
                if key == "moves":  # the tapes past each walk's moves are zero
                    assert g.shape == w.shape
                    for b, n in enumerate(want["nmoves"]):
                        assert not g[b, n:].any()
                        np.testing.assert_array_equal(g[b, :n], w[b, :n], err_msg=name)
                    continue
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {key}")


def test_a_dead_left_neighbour_fails_the_ring(tmp_path):
    """Rank 0 raises before the ring; rank 1 waits for its edges in the
    first exchange and fails (the closed connection, or at the latest the
    process group's timeout of 5 s) instead of hanging."""
    rcs, logs = run_ranks(tmp_path, "ring-fail")
    assert rcs[0] != 0 and "rank 0 fails" in logs[0]
    assert rcs[1] != 0 and "in exchange" in logs[1], logs[1][-3000:]
    assert "Connection closed" in logs[1] or "Timed out" in logs[1], logs[1][-3000:]
    assert not (tmp_path / "rank1.json").exists()


def test_a_failing_rank_fails_the_run(tmp_path):
    """Rank 1 raises before its first collective; rank 0 waits in it, and
    fails at the collective timeout (5 s) instead of hanging."""
    rcs, logs = run_ranks(tmp_path, "fail")
    assert rcs[1] != 0 and "rank 1 fails" in logs[1]
    assert rcs[0] != 0, logs[0][-3000:]
    assert not (tmp_path / "rank0.json").exists()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
