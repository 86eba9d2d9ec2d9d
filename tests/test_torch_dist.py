"""The port's pair meshes and pair-space sharding (``praline_tpu_torch/dist``)
on CPU shards, against the JAX package on its simulated 8-device mesh.

The same numpy-seeded inputs go through the JAX package's sharded calls
(``dist.allpairs.sharded_wavefront_dp``, ``align_pairs_batched`` and
``align_tracksets_batched`` with ``mesh=``, ``msa_align`` with
``mesh_shape``) and the port's on 1, 2, 3 and 8 CPU shards, shard counts
that do not divide the batch and shards left empty included: scores,
lengths, terminal cells and codes, traceback bytes and paths bit-equal,
FASTA byte-equal.  Also: ``shard_bounds``, ``make_pair_mesh``'s devices
and refusals, the checkpoint digest that leaves ``mesh_shape`` out, the
CLI's ``--devices`` and the ``dispatch:sharded:`` spans.  Tolerance 0.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import praline_tpu as jax_pkg
from praline_tpu.dist import make_pair_mesh as jax_mesh
from praline_tpu.dist import sharded_wavefront_dp as jax_sharded_dp
from praline_tpu.kernels import align_pairs_batched as jax_align_pairs
from praline_tpu.kernels import align_tracksets_batched as jax_tracksets
from praline_tpu.kernels import batch as jax_batch
from praline_tpu.msa import msa_align as jax_msa_align
from praline_tpu.types import Profile as JaxProfile
from praline_tpu.util.checkpoint import run_digest as jax_run_digest
from praline_tpu_torch import ALPHABET_AA, PralineConfig, builtin_score_matrix
from praline_tpu_torch.cli.main import main
from praline_tpu_torch.convert import profile_from_arrays
from praline_tpu_torch.dist import PairMesh, make_pair_mesh, shard_bounds, sharded_wavefront_dp
from praline_tpu_torch.dist import mesh as mesh_mod
from praline_tpu_torch.io import format_alignment_fasta, load_sequence_fasta
from praline_tpu_torch.kernels import batch
from praline_tpu_torch.msa import msa_align
from praline_tpu_torch.msa import pipeline
from praline_tpu_torch.util import metrics
from praline_tpu_torch.util.checkpoint import run_digest

torch.set_num_threads(1)

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
JB62 = jax_pkg.builtin_score_matrix("blosum62")
B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size
KEYS = ("score", "length", "ti", "tj", "tcode")
SHARDS = (1, 2, 3, 8)


def cpu_mesh(n):
    return make_pair_mesh(n, device="cpu")


def to_port(p):
    return profile_from_arrays(p.counts, p.gaps, p.alphabet.symbols)


def jax_profiles(seed, n, lo, hi):
    """Integer-count and one-hot profiles of ragged lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        L = int(rng.integers(lo, hi + 1))
        if k % 2:
            c = np.zeros((L, A), np.float32)
            c[np.arange(L), rng.integers(0, 20, L)] = 1.0
        else:
            c = rng.integers(0, 3, size=(L, A)).astype(np.float32)
            c[:, 0] += 1
        out.append(JaxProfile(c, np.zeros(L, np.float32), jax_pkg.ALPHABET_AA))
    return out


def same_result(g, w, traceback):
    if not traceback:
        return (g.score, g.length, g.ti, g.tj) == (w.score, w.length, w.ti, w.tj)
    return (g.score == w.score and g.x_range == w.x_range and g.y_range == w.y_range
            and np.array_equal(g.cols_x, w.cols_x) and np.array_equal(g.cols_y, w.cols_y))


@pytest.mark.parametrize("B,n,want", [
    (8, 1, [(0, 8)]), (8, 3, [(0, 3), (3, 6), (6, 8)]), (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),
    (9, 8, [(0, 2)] + [(k, k + 1) for k in range(2, 9)]), (0, 2, [(0, 0), (0, 0)]),
])
def test_shard_bounds_are_contiguous_and_balanced(B, n, want):
    assert shard_bounds(cpu_mesh(n), B) == want


def test_make_pair_mesh_devices_and_refusals(monkeypatch):
    """CPU shards where asked for; the card by default (no card here:
    RuntimeError); the first N cards, and the JAX package's ValueError text
    where fewer exist; across processes one device a rank, shared on one
    card."""
    m = cpu_mesh(3)
    assert m.devices == (torch.device("cpu"),) * 3 and m.shards == 3 and not m.spans_processes
    assert m.local_shards == range(3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_pair_mesh(1)
    monkeypatch.setattr(mesh_mod, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert make_pair_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError) as port_err:
        make_pair_mesh(9)
    with pytest.raises(ValueError) as jax_err:
        jax_mesh(9)
    assert str(port_err.value) == str(jax_err.value) == "need 9 devices, have 8"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 2)
    for rank in (0, 1):
        monkeypatch.setattr(mesh_mod, "process_index", lambda rank=rank: rank)
        m = make_pair_mesh()
        assert m == PairMesh((torch.device("cuda", 0),), rank, 2, 2, rank, sharing=2)
        assert make_pair_mesh(4, device="cpu").local_shards == range(2 * rank, 2 * rank + 2)
    with pytest.raises(ValueError, match="multiple of 2"):
        make_pair_mesh(3)


@pytest.mark.parametrize("mode,traceback", [("global", False), ("local", True),
                                            ("semiglobal", True)])
def test_sharded_wavefront_dp_matches_jax(mode, traceback):
    """Terminals and traceback bytes of every problem equal the JAX
    package's ``sharded_wavefront_dp`` on 8 simulated devices, on 1, 2, 3
    and 8 CPU shards."""
    rng = np.random.default_rng(len(mode) + traceback)
    B, Lx, Ly = 8, 21, 17
    cx = (rng.integers(0, 3, size=(B, Lx, A)) + (np.arange(A) == 0)).astype(np.float32)
    cy = (rng.integers(0, 3, size=(B, Ly, A)) + (np.arange(A) == 0)).astype(np.float32)
    ivx, ivy = (np.float32(1.0) / cx.sum(-1)), (np.float32(1.0) / cy.sum(-1))
    lx = rng.integers(10, Lx + 1, size=B).astype(np.int32)
    ly = rng.integers(8, Ly + 1, size=B).astype(np.int32)
    gs = (13, 7, 1) if mode == "local" else (11, 1)
    ops = (cx, ivx.astype(np.float32), cy, ivy.astype(np.float32), JB62.as_f32(), lx, ly)
    want = jax_sharded_dp(jax_mesh(8), *map(jnp.asarray, ops), gs, mode, traceback)
    for n in SHARDS:
        got = sharded_wavefront_dp(cpu_mesh(n), *ops, gs, mode, traceback)
        for key in KEYS + (("tb",) if traceback else ()):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                          err_msg=f"{key}, {n} shards")


@pytest.mark.parametrize("mode,traceback", [("global", False), ("semiglobal", True),
                                            ("local", True)])
def test_align_pairs_sharded_matches_jax(mode, traceback):
    """``align_pairs_batched(mesh=)`` on 1, 2, 3 and 8 CPU shards gives the
    JAX package's results on its 4-device mesh, with chunks of 5 (shards
    left empty) across two buckets and empty profiles."""
    profs = jax_profiles(7 + len(mode), 9, 5, 50)
    profs[4] = JaxProfile(np.zeros((0, A), np.float32), np.zeros(0, np.float32),
                          jax_pkg.ALPHABET_AA)
    pairs = [(profs[i], profs[j]) for i in range(9) for j in range(9) if (i * 5 + j) % 4 == 0]
    gs = (13, 7, 1) if mode == "local" else (11, 1)
    kw = dict(traceback=traceback, bucket_sizes=(31, 63), batch_pairs=5)
    want = jax_align_pairs(pairs, JB62, gs, mode, backend="xla", mesh=jax_mesh(4), **kw)
    port_pairs = [(to_port(a), to_port(b)) for a, b in pairs]
    for n in SHARDS:
        got = batch.align_pairs_batched(port_pairs, B62, gs, mode, device="cpu",
                                        mesh=cpu_mesh(n), **kw)
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            assert same_result(g, w, traceback), (n, k)


def test_checkpointed_route_sharded_matches_jax(monkeypatch):
    """With the budgets patched low on both sides the chunks take the
    checkpointed route (the JAX package's ``sharded_ckpt_dispatch``), on 3
    CPU shards against JAX's 4 devices."""
    monkeypatch.setattr(jax_batch, "HS_BYTES_BUDGET", 64)
    monkeypatch.setattr(jax_batch, "TB_BYTES_BUDGET", 64)
    monkeypatch.setattr(batch, "HS_BYTES_BUDGET", 64)
    monkeypatch.setattr(batch, "TB_BYTES_BUDGET", 64)
    profs = jax_profiles(3, 6, 9, 30)
    pairs = [(profs[i], profs[(i + 1) % 6]) for i in range(6)] + [(profs[0], profs[3])]
    want = jax_align_pairs(pairs, JB62, (11, 1), "global", traceback=True, bucket_sizes=(15,),
                           backend="xla", mesh=jax_mesh(4))
    batch.reset_route_counts()
    got = batch.align_pairs_batched([(to_port(a), to_port(b)) for a, b in pairs], B62, (11, 1),
                                    "global", device="cpu", traceback=True, bucket_sizes=(15,),
                                    mesh=cpu_mesh(3))
    assert batch.checkpointed_chunks > 0 and sum(batch.route_counts.values()) == 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert same_result(g, w, True), k


@pytest.mark.parametrize("traceback", [False, True])
def test_tracksets_sharded_matches_jax(traceback):
    """``align_tracksets_batched(mesh=)`` (two tracks, BLOSUM62 and PAM250
    weighted 1 and 0.5) on 1, 2, 3 and 8 CPU shards gives the JAX package's
    results on its 4-device mesh."""
    rng = np.random.default_rng(11 + traceback)
    jpam = jax_pkg.builtin_score_matrix("pam250")
    pairs = []
    for _ in range(7):
        lx, ly = (int(v) for v in rng.integers(8, 40, size=2))
        tx = JaxProfile.from_tokens(rng.integers(0, 20, lx).astype(np.int32), jax_pkg.ALPHABET_AA)
        ty = JaxProfile.from_tokens(rng.integers(0, 20, ly).astype(np.int32), jax_pkg.ALPHABET_AA)
        pairs.append(((tx, tx), (ty, ty)))
    kw = dict(traceback=traceback, bucket_sizes=(31, 63), batch_pairs=4)
    want = jax_tracksets(pairs, [JB62, jpam], (1.0, 0.5), (11, 1), "global", mesh=jax_mesh(4),
                         **kw)
    conv = {}
    port_pairs = [tuple(tuple(conv.setdefault(id(p), to_port(p)) for p in side) for side in pair)
                  for pair in pairs]
    for n in SHARDS:
        got = batch.align_tracksets_batched(port_pairs, [B62, builtin_score_matrix("pam250")],
                                            (1.0, 0.5), (11, 1), "global", device="cpu",
                                            mesh=cpu_mesh(n), **kw)
        for k, (g, w) in enumerate(zip(got, want)):
            assert same_result(g, w, traceback), (n, k)


@pytest.mark.parametrize("family,tag,cfg", [
    ("family10", "default", {}),
    ("family10", "ppglobal", {"preprofile_mode": "global"}),
])
def test_msa_align_on_a_mesh_matches_jax(family, tag, cfg):
    """``msa_align`` with ``mesh_shape=(4,)`` (four CPU shards, the merge a
    level at a time) is byte-equal to the JAX package's with
    ``mesh_shape=(4,)`` and to the golden."""
    seqs = load_sequence_fasta(TESTDATA / f"{family}.fasta", ALPHABET_AA)
    jseqs = jax_pkg.load_sequence_fasta(TESTDATA / f"{family}.fasta", jax_pkg.ALPHABET_AA)
    got = format_alignment_fasta(msa_align(seqs, B62, PralineConfig(mesh_shape=(4,), **cfg),
                                           device="cpu"))
    assert metrics.METRICS.notes["merge_walk"] == "per-level"
    want = jax_pkg.format_alignment_fasta(
        jax_msa_align(jseqs, JB62, jax_pkg.PralineConfig(mesh_shape=(4,), **cfg)))
    assert got == want == (TESTDATA / f"{family}.{tag}.golden.fasta").read_text()


def test_resume_under_another_shard_count_reuses_the_checkpoint(tmp_path, monkeypatch):
    """Both packages keep ``mesh_shape`` out of the run digest, so a run
    resumed under another ``--devices`` loads the first run's stages."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    jseqs = jax_pkg.load_sequence_fasta(TESTDATA / "family10.fasta", jax_pkg.ALPHABET_AA)
    d2 = run_digest(seqs, PralineConfig(mesh_shape=(2,)))
    assert d2 == run_digest(seqs, PralineConfig()) == run_digest(seqs, PralineConfig(
        mesh_shape=(3,))) == jax_run_digest(jseqs, jax_pkg.PralineConfig(mesh_shape=(4,)))
    ck = str(tmp_path / "ck")
    first = msa_align(seqs, B62, PralineConfig(mesh_shape=(2,), checkpoint_dir=ck), device="cpu")
    assert (tmp_path / "ck" / "distances.npz").exists()

    def no_dp(*args, **kwargs):
        raise AssertionError("the distance stage ran again")

    monkeypatch.setattr(pipeline, "batched_all_pairs", no_dp)
    again = msa_align(seqs, B62, PralineConfig(mesh_shape=(3,), checkpoint_dir=ck), device="cpu")
    assert format_alignment_fasta(again) == format_alignment_fasta(first) == \
        (TESTDATA / "family10.default.golden.fasta").read_text()


def test_cli_devices_runs_sharded(tmp_path, capsys):
    """``--devices N`` shards the run over N CPU shards (the golden bytes);
    a mesh of more cards than exist fails before the stages, exit 2."""
    out = tmp_path / "out.aln"
    assert main([str(TESTDATA / "family10.fasta"), str(out), "--device", "cpu",
                 "--devices", "3"]) == 0
    assert out.read_text() == (TESTDATA / "family10.default.golden.aln").read_text()
    assert main([str(TESTDATA / "family10.fasta"), str(out), "--device", "cpu",
                 "--devices", "0"]) == 0
    if not torch.cuda.is_available():
        assert main([str(TESTDATA / "family10.fasta"), str(out), "--devices", "2"]) == 2
        assert "is_available" in capsys.readouterr().err


def test_sharded_dispatch_spans_name_the_shard(tmp_path):
    """Under ``--profile-dir`` each shard's work is a
    ``dispatch:sharded:...:shard{s}/{n}`` span and each chunk's gather a
    ``gather:sharded:...`` span."""
    import json

    prof = tmp_path / "prof"
    assert main([str(TESTDATA / "family10.fasta"), str(tmp_path / "o.fasta"), "--device", "cpu",
                 "--devices", "2", "--profile-dir", str(prof)]) == 0
    (trace,) = prof.glob("msa_align.*.pt.trace.json")
    data = json.loads(trace.read_text())
    names = {e.get("name", "") for e in (data["traceEvents"] if isinstance(data, dict) else data)}
    assert any(n.startswith("dispatch:sharded:") and n.endswith(":shard1/2") for n in names)
    assert any(n.startswith("gather:sharded:") for n in names)


def test_call_without_a_mesh_is_one_shard_without_sharded_spans(tmp_path):
    """A call without a mesh runs the sharding layer as one shard on its
    device: the same results as on ``single_device_mesh``, and the
    unsharded trace keeps its ``dispatch:`` spans and has no
    ``dispatch:sharded:`` or ``gather:sharded:`` span."""
    import json

    from praline_tpu_torch.dist import single_device_mesh

    profs = [to_port(p) for p in jax_profiles(11, 6, 5, 40)]
    pairs = [(profs[i], profs[j]) for i in range(6) for j in range(i + 1, 6)]
    kw = dict(device="cpu", traceback=True, bucket_sizes=(63,), batch_pairs=4)
    want = batch.align_pairs_batched(pairs, B62, (11, 1), "global", **kw)
    one = batch.align_pairs_batched(pairs, B62, (11, 1), "global",
                                    mesh=single_device_mesh(torch.device("cpu")), **kw)
    assert all(same_result(g, w, True) for g, w in zip(one, want))
    prof = tmp_path / "prof"
    assert main([str(TESTDATA / "family10.fasta"), str(tmp_path / "o.fasta"), "--device", "cpu",
                 "--profile-dir", str(prof)]) == 0
    (trace,) = prof.glob("msa_align.*.pt.trace.json")
    data = json.loads(trace.read_text())
    names = {e.get("name", "") for e in (data["traceEvents"] if isinstance(data, dict) else data)}
    assert any(n.startswith("dispatch:") for n in names)
    assert not any(n.startswith(("dispatch:sharded:", "gather:sharded:")) for n in names)
