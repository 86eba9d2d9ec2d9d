"""The port's device-resident merge on the CPU against the JAX package.

Small families (n <= 10, L <= 40) go through the port's
``try_device_merge(device="cpu")`` (plain versions of every kernel,
``compose_plain`` included) and the JAX package's ``try_device_merge`` and
``oracle_msa``, run on the CPU as ``tests/e2e/test_device_merge_modes.py``
runs them; the FASTA must be byte-equal.  Also: the over-limit leaf fuzz of
``tests/e2e/test_device_merge_rescale.py`` against the JAX
``progressive_merge``; rungs forced larger, a first rung that overflows,
and every rung overflowing (None, then ``msa_align``'s per-level path);
``compose_plain`` against the JAX ``compose_profiles`` on random tapes
with over-limit columns; and the host's tier bounds against every node's
true statistics from the JAX per-level path.  Tolerance 0: the contract is
bytes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import praline_tpu as jpt
from praline_tpu.msa import device_merge as jax_dm
from praline_tpu.msa import pipeline as jax_pipeline
from praline_tpu.oracle import oracle_msa
from praline_tpu.oracle.merge import progressive_merge as jax_progressive_merge
from praline_tpu.oracle.profile import compose_profiles as jax_compose_profiles
from praline_tpu.types import GAP as JAX_GAP
from praline_tpu.types import Profile as JaxProfile
from praline_tpu.types import PralineConfig as JaxConfig
from praline_tpu.types import SequenceTree as JaxTree
from praline_tpu_torch import (
    ALPHABET_AA, METRICS, PralineConfig, Profile, Sequence, builtin_score_matrix,
)
from praline_tpu_torch.convert import sequence_from_arrays
from praline_tpu_torch.io import format_alignment_fasta, load_sequence_fasta
from praline_tpu_torch.kernels import compose as compose_mod
from praline_tpu_torch.kernels.fused_scores import matrix_stats, side_stats, tensor_core_exact
from praline_tpu_torch.msa import device_merge as dm
from praline_tpu_torch.msa import msa_align
from praline_tpu_torch.msa.pipeline import batched_all_pairs
from praline_tpu_torch.oracle.tree import build_guide_tree, similarity_from_scores
from praline_tpu_torch.types import TRACK_ID_PREPROFILE, SequenceTree

torch.set_num_threads(1)

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
B62 = builtin_score_matrix("blosum62")
JB62 = jpt.builtin_score_matrix("blosum62")
MODES = ["global", "semiglobal", "local"]


def family(n=10, L=40, seed=2):
    """tests/e2e/test_device_merge_modes.py's family: a root of L residues,
    eight substitutions a member."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=L)
    out = []
    for i in range(n):
        toks = base.copy()
        for _ in range(8):
            toks[rng.integers(0, L)] = rng.integers(0, 20)
        out.append(toks.astype(np.int32))
    return out


def divergent(n=8, seed=11):
    """The divergent local family: unrelated members of 12-39 residues."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 20, size=int(rng.integers(12, 40))).astype(np.int32)
            for _ in range(n)]


def both(tokens):
    """The same members as the port's and as the JAX package's sequences."""
    port = [sequence_from_arrays(f"s{i}", t, ALPHABET_AA.symbols) for i, t in enumerate(tokens)]
    jax = [jpt.Sequence(f"s{i}", t, jpt.ALPHABET_AA) for i, t in enumerate(tokens)]
    return port, jax


def guide_tree(seqs, cfg) -> SequenceTree:
    scores, lengths = batched_all_pairs(seqs, B62, cfg, device="cpu")
    return build_guide_tree(similarity_from_scores(scores, lengths, cfg.score_normalization),
                            cfg.linkage)


def jax_tree(tree: SequenceTree) -> JaxTree:
    return JaxTree(tree.num_leaves, tuple(tree.joins))


@pytest.mark.parametrize("mode", MODES)
def test_device_merge_matches_the_jax_walk_and_the_oracle(mode):
    port, jax = both(family())
    cfg = PralineConfig(merge_mode=mode)
    tree = guide_tree(port, cfg)
    METRICS.reset()
    got = dm.try_device_merge(port, tree, B62, cfg, device="cpu")
    assert got is not None and METRICS.notes["merge_walk"] == "device"
    jcfg = JaxConfig(merge_mode=mode, backend="xla")
    want = jax_dm.try_device_merge(jax, jax_tree(tree), JB62, jcfg)
    assert want is not None
    text = format_alignment_fasta(got)
    assert text == jpt.format_alignment_fasta(want)
    assert text == jpt.format_alignment_fasta(oracle_msa(jax, JB62, jcfg))


def test_divergent_local_family():
    port, jax = both(divergent())
    cfg = PralineConfig(merge_mode="local")
    tree = guide_tree(port, cfg)
    got = dm.try_device_merge(port, tree, B62, cfg, device="cpu")
    assert got is not None
    jcfg = JaxConfig(merge_mode="local", backend="xla")
    text = format_alignment_fasta(got)
    assert text == jpt.format_alignment_fasta(jax_dm.try_device_merge(jax, jax_tree(tree), JB62,
                                                                      jcfg))
    assert text == jpt.format_alignment_fasta(oracle_msa(jax, JB62, jcfg))


def huge_preprofile(rng, name, L, total):
    """tests/e2e/test_device_merge_rescale.py's leaf: preprofile column
    totals past COUNT_LIMIT (992), within the exactness guard.  Returns the
    port's and the JAX package's sequence."""
    toks = rng.integers(0, 20, size=L).astype(np.int32)
    counts = np.zeros((L, ALPHABET_AA.size), np.float32)
    counts[np.arange(L), toks] = np.float32(total - 20)
    for k in range(4):
        counts[np.arange(L), (toks + 1 + k) % 20] += 5.0
    gaps = np.zeros(L, np.float32)
    port = sequence_from_arrays(name, toks, ALPHABET_AA.symbols).with_profile(
        TRACK_ID_PREPROFILE, Profile(counts, gaps, ALPHABET_AA))
    jax = jpt.Sequence(name, toks, jpt.ALPHABET_AA).with_profile(
        TRACK_ID_PREPROFILE, JaxProfile(counts, gaps, jpt.ALPHABET_AA))
    return port, jax


def rescale_family(seed):
    rng = np.random.default_rng(seed)
    pairs = [huge_preprofile(rng, f"s{i}", int(rng.integers(12, 30)),
                             int(rng.integers(995, 2000))) for i in range(4)]
    return [p for p, _ in pairs], [j for _, j in pairs]


def dyadic_family(seed):
    """Four preprofile leaves within COUNT_LIMIT (totals of 300-900, so the
    plan keeps their counts), leaf 0 with one dyadic count (half a residue):
    every node above it has counts the tensor-core predicate refuses (P1)."""
    rng = np.random.default_rng(seed)
    pairs = [huge_preprofile(rng, f"s{i}", int(rng.integers(12, 30)),
                             int(rng.integers(300, 900))) for i in range(4)]
    port, jax = pairs[0]
    port.profiles[TRACK_ID_PREPROFILE].counts[0, 0] += np.float32(0.5)  # the array both hold
    assert np.array_equal(port.profiles[TRACK_ID_PREPROFILE].counts,
                          jax.profiles[TRACK_ID_PREPROFILE].counts)
    return [p for p, _ in pairs], [j for _, j in pairs]


@pytest.mark.parametrize("seed", range(12))
def test_over_limit_leaves_match_the_jax_progressive_merge(seed):
    port, jax = rescale_family(seed)
    tree = build_guide_tree(np.ones((4, 4)) - np.eye(4), "average")
    cfg = PralineConfig()
    got = dm.try_device_merge(port, tree, B62, cfg, device="cpu")
    assert got is not None, "device merge unexpectedly fell back"
    want = jax_progressive_merge(jax, jax_tree(tree), JB62, cfg.gap_series, "global")
    assert format_alignment_fasta(got) == jpt.format_alignment_fasta(want), seed


@pytest.mark.parametrize("mode", MODES)
def test_forced_larger_rungs_give_the_same_bytes(monkeypatch, mode):
    port, _ = both(family(seed=5))
    cfg = PralineConfig(merge_mode=mode)
    tree = guide_tree(port, cfg)
    want = dm.try_device_merge(port, tree, B62, cfg, device="cpu")
    assert want is not None and METRICS.notes["merge_rung"] == 63
    for rungs in ((127,), (255,), (383,)):
        monkeypatch.setattr(dm, "ladder", lambda max_len: rungs)
        METRICS.reset()
        got = dm.try_device_merge(port, tree, B62, cfg, device="cpu")
        assert METRICS.notes["merge_rung"] == rungs[0]
        assert format_alignment_fasta(got) == format_alignment_fasta(want)


def test_a_first_rung_that_overflows_retries(monkeypatch):
    """family10's longest member has 95 residues and its alignment 98
    columns: a first rung of 95 overflows, the walk reruns at 127."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    cfg = PralineConfig()
    tree = guide_tree(seqs, cfg)
    longest = max(s.length for s in seqs)
    monkeypatch.setattr(dm, "ladder", lambda max_len: (max_len, 127))
    METRICS.reset()
    got = dm.try_device_merge(seqs, tree, B62, cfg, device="cpu")
    assert METRICS.notes["merge_attempts"] == [longest, 127]
    assert METRICS.notes["merge_rung"] == 127
    assert format_alignment_fasta(got) == (TESTDATA / "family10.default.golden.fasta").read_text()


def test_every_rung_overflowing_takes_the_per_level_path(monkeypatch):
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    longest = max(s.length for s in seqs)
    monkeypatch.setattr(dm, "ladder", lambda max_len: (max_len,))
    tree = guide_tree(seqs, PralineConfig())
    assert dm.try_device_merge(seqs, tree, B62, PralineConfig(), device="cpu") is None
    aln = msa_align(seqs, B62, PralineConfig(), device="cpu")
    assert METRICS.notes["merge_walk"] == "per-level"
    assert METRICS.notes["merge_attempts"] == [longest]
    assert format_alignment_fasta(aln) == (TESTDATA / "family10.default.golden.fasta").read_text()


def test_none_exactly_under_the_reference_conditions():
    port, jax = both(family(n=4))
    tree = guide_tree(port, PralineConfig())
    pam = builtin_score_matrix("pam250")
    cases = [
        (port, tree, pam, PralineConfig()),  # bound**2 * 17 >= 2**24
        (port[:1], SequenceTree(1, ()), B62, PralineConfig()),
    ]
    for seqs, t, m, cfg in cases:
        assert dm.try_device_merge(seqs, t, m, cfg, device="cpu") is None
        jcfg = JaxConfig(merge_mode=cfg.merge_mode, backend="xla")
        jm = jpt.builtin_score_matrix(m.name)
        jseqs = [jpt.Sequence(s.name, s.tokens, jpt.ALPHABET_AA) for s in seqs]
        assert jax_dm.try_device_merge(jseqs, jax_tree(t), jm, jcfg) is None
    empty = [*port[:2], Sequence("e", np.zeros(0, np.int32), ALPHABET_AA)]
    assert dm.try_device_merge(empty, SequenceTree(3, ((0, 1), (3, 2))), B62, PralineConfig(),
                               device="cpu") is None
    assert dm.plan_merge(port, tree, B62, PralineConfig()) is not None


def random_tape(rng, Cl, Cr):
    """A global full-coverage move tape (terminal -> origin) of Cl x takes
    and Cr y takes, and its origin -> terminal columns."""
    moves = []
    i, j = Cl, Cr
    while i or j:
        m = rng.choice([mv for mv, ok in ((1, i and j), (2, i), (3, j)) if ok])
        moves.append(m)
        i -= m in (1, 2)
        j -= m in (1, 3)
    m = np.array(moves[::-1])
    cols_x = np.where((m == 1) | (m == 2), np.cumsum((m == 1) | (m == 2)) - 1, JAX_GAP)
    cols_y = np.where((m == 1) | (m == 3), np.cumsum((m == 1) | (m == 3)) - 1, JAX_GAP)
    return np.array(moves, np.uint8), cols_x.astype(np.int32), cols_y.astype(np.int32)


def test_compose_plain_matches_compose_profiles():
    """J joins of random integer profiles (some columns past COUNT_LIMIT
    once merged) along random tapes, composed into a node table: each
    output slot equals the JAX ``compose_profiles`` (counts, gaps), with
    inverses of its integer totals, length and member count; columns past
    the length are zero with inverse 1."""
    rng = np.random.default_rng(7)
    A, C, J = ALPHABET_AA.size, 96, 5
    M = 3 * J
    lens = rng.integers(1, 48, size=2 * J)
    mems = rng.integers(1, 600, size=2 * J)
    counts = np.zeros((M, C, A), np.float32)
    gaps = np.zeros((M, C), np.float32)
    profs = []
    for s in range(2 * J):
        c = rng.integers(0, 40, size=(lens[s], A)).astype(np.float32)
        c[rng.random(lens[s]) < 0.3] *= 2  # column totals past 992 once merged
        g = rng.integers(0, 80, size=lens[s]).astype(np.float32)
        counts[s, : lens[s]], gaps[s, : lens[s]] = c, g
        profs.append(JaxProfile(c, g, jpt.ALPHABET_AA))
    inv_table = compose_mod.inverse_table(4000.0)
    table = compose_mod.NodeTable(
        torch.from_numpy(counts), torch.from_numpy(gaps),
        torch.from_numpy(compose_mod.column_inverses(counts, inv_table)),
        torch.from_numpy(np.r_[lens, np.zeros(J)].astype(np.int32)),
        torch.from_numpy(np.r_[mems, np.zeros(J)].astype(np.int32)))
    tapes, cols = np.zeros((J, 2 * C), np.uint8), []
    for j in range(J):
        t, cx, cy = random_tape(rng, lens[2 * j], lens[2 * j + 1])
        tapes[j, : len(t)] = t
        cols.append((cx, cy))
    nm = torch.from_numpy((tapes > 0).sum(axis=1).astype(np.int32))
    li = torch.arange(0, 2 * J, 2, dtype=torch.int32)
    tape, nmv = compose_mod.compose(torch.from_numpy(tapes), nm, li * 0, li * 0, table, li,
                                    li + 1, torch.arange(2 * J, M, dtype=torch.int32),
                                    torch.from_numpy(inv_table), "global")
    assert torch.equal(tape, torch.from_numpy(tapes)) and torch.equal(nmv, nm)
    over = 0
    for j, (cx, cy) in enumerate(cols):
        want = jax_compose_profiles(profs[2 * j], profs[2 * j + 1], int(mems[2 * j]),
                                    int(mems[2 * j + 1]), cx, cy)
        o, n = 2 * J + j, len(cx)
        side = lambda p, n_other, idx: np.where(
            idx >= 0, p.counts.sum(1)[idx] + p.gaps[idx], n_other)
        over += int((side(profs[2 * j], mems[2 * j], cx) + side(profs[2 * j + 1],
                                                              mems[2 * j + 1], cy) > 992).sum())
        assert np.array_equal(table.counts[o, :n].numpy(), want.counts)
        assert np.array_equal(table.gaps[o, :n].numpy(), want.gaps)
        tot = np.maximum(want.counts.sum(1, dtype=np.float32), np.float32(1))
        assert np.array_equal(table.inv[o, :n].numpy(), (np.float32(1) / tot).astype(np.float32))
        assert not table.counts[o, n:].any() and not table.gaps[o, n:].any()
        assert (table.inv[o, n:] == 1.0).all()
        assert int(table.lens[o]) == n and int(table.mems[o]) == mems[2 * j] + mems[2 * j + 1]
    assert over


def test_compose_plain_drops_columns_past_the_capacity():
    """A merged profile longer than the capacity: the length stored is the
    capacity, the tape length the true one, and every column written."""
    A, C = 4, 6
    counts = torch.zeros((3, C, A))
    counts[0, :5, 0] = 1
    counts[1, :4, 1] = 1
    gaps = torch.zeros((3, C))
    table = compose_mod.NodeTable(counts, gaps, torch.ones((3, C)),
                                  torch.tensor([5, 4, 0], dtype=torch.int32),
                                  torch.ones(3, dtype=torch.int32))
    moves = torch.tensor([[3, 3, 3, 3, 2, 2, 2, 2, 2, 0, 0, 0]], dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    tape, nmv = compose_mod.compose(moves, torch.tensor([9], dtype=torch.int32), one, one, table,
                                    one, one + 1, one + 2, torch.from_numpy(
                                        compose_mod.inverse_table(10.0)), "global")
    assert int(nmv) == 9 and int(table.lens[2]) == C
    assert table.gaps[2].tolist() == [1.0] * C  # x columns 0-4, then y columns (each a gap in x)
    assert table.counts[2, :5, 0].tolist() == [1.0] * 5 and table.counts[2, 5, 1] == 1.0


def jax_node_profiles(jax_seqs, tree: SequenceTree, cfg: JaxConfig, monkeypatch):
    """Every node's profile on the JAX package's per-level path (its
    batched aligner; backend "oracle" keeps it off the device walk)."""
    nodes = {}
    real_node, real_compose = jax_pipeline.node_profile, jax_pipeline.compose_profiles

    def node(aln):
        p = real_node(aln)
        nodes[len(nodes)] = p
        return p

    def comp(*args):
        p = real_compose(*args)
        nodes[len(nodes)] = p
        return p

    monkeypatch.setattr(jax_pipeline, "node_profile", node)
    monkeypatch.setattr(jax_pipeline, "compose_profiles", comp)
    jax_pipeline.batched_progressive_merge(jax_seqs, jax_tree(tree), JB62, cfg)
    monkeypatch.undo()
    n = tree.num_leaves
    order = [n + k for level in jax_pipeline._merge_levels(jax_tree(tree)) for k in level]
    return [nodes[i] for i in range(n)] + [nodes[n + order.index(n + k)]
                                           for k in range(len(tree.joins))]


@pytest.mark.parametrize("kind", ["one-hot", "rescale", "dyadic"])
def test_tier_bounds_hold_the_true_statistics(monkeypatch, kind):
    """For every node the host bound is at least the true count and total
    (from the JAX per-level path), so a level on "mma" has every join's
    true statistics admitted.  The one-hot family and the over-limit
    family (merged counts past 255, up to COUNT_LIMIT: two u8 limbs of Cy)
    take "mma" at every level; the dyadic family takes "scalar" at every
    level holding a join whose true statistics the predicate refuses, the
    root's among them."""
    if kind == "one-hot":
        port, jax = both(family())
        cfg = PralineConfig()
        tree = guide_tree(port, cfg)
    else:
        port, jax = rescale_family(3) if kind == "rescale" else dyadic_family(3)
        tree = build_guide_tree(np.ones((4, 4)) - np.eye(4), "average")
        cfg = PralineConfig()
    s = B62.as_f32()
    true = [side_stats(p.counts, s) for p in jax_node_profiles(jax, tree, JaxConfig(
        backend="oracle"), monkeypatch)]
    plan = dm.plan_merge(port, tree, B62, cfg)
    bounds = dm.node_bounds([side_stats(p.counts) for p in plan.leaves], tree,
                            float(np.abs(B62.scores).max()))
    for t, b in zip(true, bounds):
        assert t.cmax <= b.cmax and t.tot <= b.tot and t.tmax <= b.tmax and (t.ints or not b.ints)
    m = matrix_stats(s)
    for level, tier in zip(plan.levels, plan.tiers):
        for k in level:
            l, r = tree.joins[k]
            if tier == "mma":
                assert tensor_core_exact(true[l], true[r], m)
    if kind == "rescale":
        assert max(true[n].cmax for n in range(len(port), len(true))) > 255
    if kind != "dyadic":
        assert set(plan.tiers) == {"mma"}
    else:
        assert plan.tiers[-1] == "scalar"
        assert any(not tensor_core_exact(true[l], true[r], m) for l, r in tree.joins)
        for level, tier in zip(plan.levels, plan.tiers):
            if any(not tensor_core_exact(true[tree.joins[k][0]], true[tree.joins[k][1]], m)
                   for k in level):
                assert tier == "scalar"


def test_ladder_steps_by_128_past_127():
    assert dm.ladder(40) == (63, 127, 255)
    assert dm.ladder(95) == (127, 255, 383)
    assert dm.ladder(1000) == (1279, 1663, 2047)  # msa128's longest member
    assert dm.ladder(2397) == (3071, 3839, 4735)  # long32's: the fused lane cap, then past it
    assert dm.ladder(4955) == (6271, 7807, 9727)  # long8's


def test_ladder_stops_at_the_largest_traceback_the_card_takes():
    """No rung past LADDER_TOP, the reference's largest (32767) and the
    largest (C, C) full traceback at the budgets as written; a leaf longer
    than it gives no rung."""
    from praline_tpu_torch.kernels import batch

    assert dm.LADDER_TOP == jax_dm.C_BUCKETS[-1] == 32767
    assert batch.choose_route("cuda", dm.LADDER_TOP, dm.LADDER_TOP, True) == "tiled"
    # past it the card runs the traceback checkpointed (no card here: the
    # budgets as written), and the ladder stops all the same
    assert batch.choose_route("cuda", dm.LADDER_TOP + 1, dm.LADDER_TOP + 1, True) == \
        "checkpointed"
    assert dm.ladder(20000) == (25087, 31359, 32767)
    assert dm.ladder(26926) == (32767,)  # titin's N2B isoform
    assert dm.ladder(32767) == (32767,)
    assert dm.ladder(32768) == ()
    for n in range(1, 40000, 97):
        for rung in dm.ladder(n):
            assert n <= rung <= dm.LADDER_TOP
            batch.choose_route("cuda", rung, rung, True)


@pytest.mark.parametrize("length, rungs", [(27000, (32767,)), (32768, None)])
def test_a_long_leaf_plans_within_the_ladder_or_gives_none(length, rungs):
    """A family with a leaf of ``length`` residues: the plan's rungs stay
    within LADDER_TOP, or there is no plan (None, as the JAX package gives
    past its largest rung)."""
    rng = np.random.default_rng(length)
    port, jax = both([rng.integers(0, 20, size=n).astype(np.int32) for n in (length, 30)])
    tree = SequenceTree(2, ((0, 1),))
    plan = dm.plan_merge(port, tree, B62, PralineConfig())
    assert (plan and plan.rungs) == rungs
    if rungs is None:
        assert jax_dm.try_device_merge(jax, jax_tree(tree), JB62, JaxConfig(backend="xla")) is None
