"""The producer's two tiers: the tensor-core predicate, the integer limb
arithmetic of ``csrc/scores_mma.cu`` and the routing by the predicate.

Tolerance 0 throughout: the "mma" tier is exact under
``fused_scores.tensor_core_exact`` (the proof sits beside the kernel), so
its arithmetic, run here in torch int64 by ``skewed_pair_scores_limbs``,
gives the bits of the plain producer and of the JAX package's
``praline_tpu.kernels.scores.skewed_pair_scores``.  The predicate is held
at each of its edges and against the JAX package's MXU predicate
``fast_mxu_exact`` where the two must agree.  The kernel itself is held
against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from praline_tpu.kernels.batch import fast_mxu_exact
from praline_tpu.kernels.scores import skewed_pair_scores as jax_skewed
from praline_tpu_torch import ALPHABET_AA, Profile, builtin_score_matrix
from praline_tpu_torch.bench import count_profiles
from praline_tpu_torch.convert import operands_from_numpy
from praline_tpu_torch.kernels import batch, fused_scores
from praline_tpu_torch.kernels.fused_scores import (
    MatrixStats, SideStats, matrix_stats, side_stats, skewed_pair_scores_limbs, tensor_core_exact,
)
from praline_tpu_torch.kernels.scores import skewed_pair_scores

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
PAM250 = builtin_score_matrix("pam250")
A = ALPHABET_AA.size


def member_profile(rng, members: int, L: int) -> Profile:
    """A merged profile of ``members`` random sequences: every column's
    counts sum to ``members``."""
    c = np.zeros((L, A), np.float32)
    for _ in range(members):
        np.add.at(c, (np.arange(L), rng.integers(0, 20, size=L)), 1.0)
    return Profile(c, np.zeros(L, np.float32), ALPHABET_AA)


def stats_pair(px, py, s):
    """(x stats with tmax, y stats, matrix stats) of two lists of count
    arrays."""
    cx = np.concatenate([np.asarray(c, np.float32) for c in px])
    cy = np.concatenate([np.asarray(c, np.float32) for c in py])
    return side_stats(cx, s), side_stats(cy), matrix_stats(s)


def jax_stats(counts) -> dict:
    """The statistics ``praline_tpu.kernels.batch.ProfileArena.stack``
    gives ``fast_mxu_exact``."""
    c = np.concatenate([np.asarray(x, np.float64) for x in counts])
    return {"ints": bool(np.all(c == np.rint(c))), "cmax": float(c.max(initial=0.0)),
            "max_tot": float(c.sum(axis=1).max(initial=0.0))}


def both_predicates(px, py, s):
    """(the port's tensor_core_exact, the JAX package's fast_mxu_exact)."""
    s = np.asarray(s, np.float32)
    port = tensor_core_exact(*stats_pair(px, py, s))
    m = matrix_stats(s)
    return port, fast_mxu_exact(m.max_s, m.integral, jax_stats(px), jax_stats(py))


def matrix_with(entries, A_=A):
    s = np.zeros((A_, A_), np.float32)
    for (a, c), v in entries.items():
        s[a, c] = v
    return s


def onehot_counts(rng, L, A_=A):
    c = np.zeros((L, A_), np.float32)
    c[np.arange(L), rng.integers(0, min(A_, 20), size=L)] = 1.0
    return c


# ---- the predicate -------------------------------------------------------


def test_main_paths_are_admitted_and_agree_with_jax():
    """The all-pairs headline's count profiles, merge levels of a
    128-member family (msa128), of 32 and of 8 members (long32, long8) under
    BLOSUM62, and the tracks' one-hot profiles under BLOSUM62 and PAM250:
    admitted by the port, and by the JAX package's MXU predicate too."""
    rng = np.random.default_rng(0)
    heads = [p.counts for p in count_profiles(rng, 6, 20, 60, A)]
    cases = [(heads[:3], heads[3:], B62.as_f32())]
    for members in (128, 32, 8):
        for k in (1, members // 2, members - 1):
            cases.append(([member_profile(rng, k, 40).counts],
                          [member_profile(rng, members - k, 50).counts], B62.as_f32()))
    for m in (B62, PAM250):
        cases.append(([onehot_counts(rng, 30)], [onehot_counts(rng, 45)], m.as_f32()))
    for px, py, s in cases:
        assert both_predicates(px, py, s) == (True, True)


@pytest.mark.parametrize("case", ["dyadic_x", "dyadic_y", "fractional_s", "negative_count"])
def test_refusals_shared_with_jax(case):
    """Inputs neither tier of either package may take exactly."""
    rng = np.random.default_rng(1)
    cx, cy, s = onehot_counts(rng, 20) * 2, onehot_counts(rng, 20) * 2, B62.as_f32()
    if case == "dyadic_x":
        cx = cx * np.float32(0.25)
    elif case == "dyadic_y":
        cy[3, 0] += np.float32(0.5)
    elif case == "fractional_s":
        s = s + np.float32(0.5)
    else:
        cy[0, 0] = -1.0
    port, jax = both_predicates([cx], [cy], s)
    assert port is False
    if case != "negative_count":  # the JAX package never meets negative counts
        assert jax is False


def test_y_counts_at_the_u8_edge():
    """255 admitted, 256 refused (a u8 operand); the JAX package's bf16
    operand takes 256, so there the two differ by design."""
    cx = np.zeros((2, A), np.float32)
    cx[:, 0] = 1
    for count, want in ((255, True), (256, False)):
        cy = np.zeros((3, A), np.float32)
        cy[1, 0] = count
        port, jax = both_predicates([cx], [cy], B62.as_f32())
        assert port is want and jax is True


@pytest.mark.parametrize("entry,count,want", [(7, 4681, True), (-7, 4681, True),
                                              (8, 4096, False), (-8, 4096, False),
                                              (127, 258, True), (128, 256, False)])
def test_t_at_the_limb_edge(entry, count, want):
    """|T| = 32767 admitted, |T| = 32768 refused: T >> 8 must be an s8."""
    s = matrix_with({(0, 0): entry, (1, 1): 1})
    cx = np.zeros((2, A), np.float32)
    cx[0, 0] = count
    cx[1, 1] = 1
    cy = np.zeros((2, A), np.float32)
    cy[:, 0] = 1
    x, y, m = stats_pair([cx], [cy], s)
    assert x.tmax == abs(entry) * count
    assert tensor_core_exact(x, y, m) is want


@pytest.mark.parametrize("field,edge,want", [
    # P5: tot_x * tot_y * max_s against 2**24
    ("p5", 2**24 - 1, True), ("p5", 2**24, False),
    # P4: tot_x * max_s against 2**31 (tot_y = 0: H is all zeros)
    ("p4", 2**31 - 1, True), ("p4", 2**31, False),
])
def test_accumulation_bounds(field, edge, want):
    m = MatrixStats(integral=True, max_s=1.0)
    if field == "p5":
        x = SideStats(True, 1.0, float(edge), 1.0)
        y = SideStats(True, 1.0, 1.0)
    else:
        x = SideStats(True, 1.0, float(edge), 1.0)
        y = SideStats(True, 0.0, 0.0)
    assert tensor_core_exact(x, y, m) is want


@pytest.mark.parametrize("per_residue,jax_admits", [(200, False), (148, True)])
def test_jax_split_bound_differs_where_the_port_knows_t(per_residue, jax_admits):
    """The JAX package bounds T by max_tot * max_s < 32768; the port uses
    the exact max |T| of x.  A column of ``per_residue`` copies of each of
    the 20 residues under BLOSUM62: a total of 4000 (4000 * 11 >= 32768)
    is refused by the JAX package and admitted by the port, whose T stays
    small; 2960 (2960 * 11 < 32768) is admitted by both."""
    cx = np.zeros((2, A), np.float32)
    cx[0, :20] = per_residue
    cy = np.zeros((1, A), np.float32)
    cy[0, 0] = 1
    x, _, _ = stats_pair([cx], [cy], B62.as_f32())
    assert x.tmax <= 32767 < x.tot * 11 or jax_admits
    assert both_predicates([cx], [cy], B62.as_f32()) == (True, jax_admits)


# ---- the limb arithmetic -------------------------------------------------


def edge_operands(seed, B, Lx, Ly, A_, s):
    """Seeded counts at the predicate's edges for matrix ``s`` (max |S| =
    127): x columns of total 258, among them a column of 258 copies of a
    residue whose row of S holds +127 and -127 (|T| = 32766, just under
    2**15); y columns of total 510 with counts of 255, among them one that
    meets the +127 entries twice (|H_int| = 32766 * 510 = 16,710,660, just
    under 2**24)."""
    rng = np.random.default_rng(seed)
    cx = np.zeros((B, Lx, A_), np.float32)
    cy = np.zeros((B, Ly, A_), np.float32)
    for b in range(B):
        for i in range(Lx):
            cx[b, i] = rng.multinomial(258, np.ones(A_) / A_)
        for j in range(Ly):
            k = rng.choice(A_, 2, replace=False)
            cy[b, j, k] = 255
    cx[:, 0] = 0
    cx[:, 0, 0] = 258  # T[0, c] = 258 * S[0, c]
    cy[:, 0] = 0
    cy[:, 0, 1] = cy[:, 0, 2] = 255  # S[0, 1] = S[0, 2] = 127
    inv = lambda c: (np.float32(1.0) / np.maximum(c.sum(-1, dtype=np.float32), 1)).astype(np.float32)
    return cx, inv(cx), cy, inv(cy)


def edge_matrix(seed, A_):
    rng = np.random.default_rng(seed)
    s = rng.integers(-127, 128, size=(A_, A_)).astype(np.float32)
    s[0, 1] = s[0, 2] = 127
    s[0, 3] = -127
    return s


@pytest.mark.parametrize("B,Lx,Ly,A_", [(2, 9, 14, 4), (1, 13, 7, 32), (3, 6, 6, 23)])
def test_limbs_equal_plain_and_jax_at_the_edges(B, Lx, Ly, A_):
    s = edge_matrix(B * 100 + A_, A_)
    cx, ivx, cy, ivy = edge_operands(B + Lx + Ly, B, Lx, Ly, A_, s)
    x, y, m = stats_pair([cx.reshape(-1, A_)], [cy.reshape(-1, A_)], s)
    assert x.tmax == 32766 and y.cmax == 255 and m.max_s == 127
    assert x.tot * y.tot * m.max_s == 258 * 510 * 127 < 2**24
    assert tensor_core_exact(x, y, m)
    ops = operands_from_numpy(cx, ivx, cy, ivy, s, [1], [1], "cpu")[:5]
    h_int = (torch.from_numpy(cx).double() @ torch.from_numpy(s).double()
             @ torch.from_numpy(cy).double().transpose(1, 2))
    assert h_int.abs().max().item() == 32766 * 510  # the largest |H_int| is met
    assert h_int.min().item() < 0  # and negative sums too
    got = skewed_pair_scores_limbs(*ops)
    plain = skewed_pair_scores(*ops)
    want = np.asarray(jax_skewed(cx, ivx, cy, ivy, s))
    assert got.shape == (Lx + Ly + 1, B, Lx + 1)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("matrix", [B62, PAM250])
def test_limbs_one_pass_on_one_hot_profiles(matrix):
    """One-hot counts: every |T| <= 127, the kernel's single-pass case."""
    rng = np.random.default_rng(7)
    cx = np.stack([onehot_counts(rng, 11) for _ in range(2)])
    cy = np.stack([onehot_counts(rng, 17) for _ in range(2)])
    cx[1, 8:] = 0  # padded columns (inverse 1.0, as the stacks pad them)
    ivx, ivy = np.ones(cx.shape[:2], np.float32), np.ones(cy.shape[:2], np.float32)
    s = matrix.as_f32()
    ops = operands_from_numpy(cx, ivx, cy, ivy, s, [1], [1], "cpu")[:5]
    got = skewed_pair_scores_limbs(*ops)
    want = np.asarray(jax_skewed(cx, ivx, cy, ivy, s))
    assert torch.equal(got.view(torch.int32), skewed_pair_scores(*ops).view(torch.int32))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


# ---- routing -------------------------------------------------------------


def test_wrapper_on_the_cpu_launches_nothing_on_either_tier():
    s = edge_matrix(8, 23)
    ops = operands_from_numpy(*edge_operands(8, 2, 5, 6, 23, s), s, [1], [1], "cpu")[:5]
    before = dict(fused_scores.launches)
    for tier in ("mma", "scalar"):
        got = fused_scores.fused_skewed_scores(*ops, tier=tier)
        assert torch.equal(got, skewed_pair_scores(*ops))
    assert fused_scores.launches == before
    with pytest.raises(ValueError):
        fused_scores.fused_skewed_scores(*ops, tier="fast1")


@pytest.fixture
def tiers_seen(monkeypatch):
    seen = []
    real = batch.fused_skewed_scores

    def record(*args, tier, **kw):
        seen.append(tier)
        return real(*args, tier=tier, **kw)

    monkeypatch.setattr(batch, "fused_skewed_scores", record)
    return seen


@pytest.mark.parametrize("kind,want", [
    ("onehot", ["mma"] * 3), ("members", ["mma"] * 3), ("dyadic", ["scalar"] * 3),
    ("count_256", ["mma", "scalar", "scalar"]),
])
def test_batch_driver_routes_by_the_predicate(tiers_seen, kind, want):
    """Every chunk's producer launch takes the tier the predicate gives the
    chunk's own profiles (the plain version runs either way on the CPU).
    Chunks of two of the six pairs (0,1),(0,2) | (0,3),(1,2) | (1,3),(2,3):
    profile 2 dyadic touches all three; a count of 256 in profile 3 (always
    the y side) the last two."""
    rng = np.random.default_rng(9)
    if kind == "onehot":
        profs = [Profile.from_tokens(rng.integers(0, 20, size=30).astype(np.int32), ALPHABET_AA)
                 for _ in range(4)]
    else:
        profs = [member_profile(rng, 3, 30) for _ in range(4)]
        if kind == "dyadic":
            profs[2] = Profile(profs[2].counts * np.float32(0.5), profs[2].gaps, ALPHABET_AA)
        elif kind == "count_256":
            profs[3].counts[0, 0] = 256
    pairs = [(profs[i], profs[j]) for i in range(4) for j in range(i + 1, 4)]
    got = batch.align_pairs_batched(pairs, B62, (11, 1), "global", device="cpu",
                                    bucket_sizes=(63,), batch_pairs=2)
    assert tiers_seen == want
    assert all(np.isfinite(r.score) for r in got)


def test_composites_route_each_track_by_the_predicate(tiers_seen):
    rng = np.random.default_rng(10)
    toks = [rng.integers(0, 20, size=int(n)).astype(np.int32) for n in (20, 25, 30)]
    one_hot = [Profile.from_tokens(t, ALPHABET_AA) for t in toks]
    dyadic = [Profile(p.counts * np.float32(0.5), p.gaps, ALPHABET_AA) for p in one_hot]
    pairs = [((one_hot[i], dyadic[i]), (one_hot[j], dyadic[j])) for i, j in ((0, 1), (1, 2))]
    batch.align_tracksets_batched(pairs, [B62, PAM250], (1.0, 0.5), (11, 1), "global",
                                  device="cpu", bucket_sizes=(63,))
    assert tiers_seen == ["mma", "scalar"]


def test_producer_ablation_variants_apply_to_the_kernel_source():
    """Each variant of ``producer_ablation`` is a textual edit of
    ``csrc/scores_mma.cu``: every one of them still finds its text."""
    from praline_tpu_torch import producer_ablation

    for name, subs in producer_ablation.VARIANTS.items():
        text = producer_ablation.variant_source(subs)
        assert (text == producer_ablation.SOURCE.read_text()) == (not subs), name
