"""The long routes of the port against the JAX package's, bit for bit.

The plain checkpointed DP (``kernels/scan.py::wavefront_dp_checkpointed``)
is held against the JAX ``wavefront_dp_checkpointed`` over modes x gap
series x block sizes; the pieces the Hopper route is built from (the
forward pass's snapshot, each block's resumed bytes, the block walk)
against the full traceback and ``replay_moves_plain``; the batch
aligner's checkpointed route (budgets monkeypatched low) against the JAX
``align_pairs_batched`` under the same patch; the budgets scaled by an
80 GB card; and the in-place composite source against
``composite_skewed_scores``.  Tolerance 0.  The CUDA launches are held
against these plain versions in ``test_torch_cuda.py``.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels import align_pairs_batched as jax_align_pairs
from praline_tpu.kernels import align_tracksets_batched as jax_align_tracks
from praline_tpu.kernels import batch as jax_batch
from praline_tpu.kernels.scan import wavefront_dp_checkpointed as jax_checkpointed
from praline_tpu.types import Profile as JaxProfile
from praline_tpu_torch import builtin_score_matrix as port_matrix
from praline_tpu_torch.convert import profile_from_arrays
from praline_tpu_torch.kernels import batch, replay, scan, tiled_dp
from praline_tpu_torch.kernels.scores import composite_skewed_scores, skewed_pair_scores
from praline_tpu_torch.msa import device_merge as dm

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
PAM = builtin_score_matrix("pam250")
A = ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]
KEYS = ("score", "length", "ti", "tj", "tcode")
H100_MEMORY = 85_031_714_816  # total_memory of an H100 80GB HBM3


def seed_of(*key):
    return zlib.crc32(repr(key).encode())


def operands(rng, B, Lx, Ly):
    cx = (rng.integers(0, 3, size=(B, Lx, A)) + (np.arange(A) == 0)).astype(np.float32)
    cy = (rng.integers(0, 3, size=(B, Ly, A)) + (np.arange(A) == 0)).astype(np.float32)
    ivx = (np.float32(1.0) / cx.sum(-1)).astype(np.float32)
    ivy = (np.float32(1.0) / cy.sum(-1)).astype(np.float32)
    lx = rng.integers(max(1, Lx // 2), Lx + 1, size=B).astype(np.int32)
    ly = rng.integers(max(1, Ly // 2), Ly + 1, size=B).astype(np.int32)
    return cx, ivx, cy, ivy, lx, ly


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gs", [(11, 1), (13, 7, 1)])
@pytest.mark.parametrize("interval", [None, 2, 7, 200])
def test_checkpointed_matches_jax(mode, gs, interval):
    """Terminals, move counts and tapes equal the JAX checkpointed DP's for
    every block size: R = 2, an odd R and R past D."""
    rng = np.random.default_rng(seed_of(mode, gs, interval))
    cx, ivx, cy, ivy, lx, ly = operands(rng, 3, 45, 33)
    s = B62.as_f32()
    want = jax_checkpointed(*map(jnp.asarray, (cx, ivx, cy, ivy, s, lx, ly)),
                            gap_series=gs, mode=mode, interval=interval)
    got = scan.wavefront_dp_checkpointed(*map(torch.from_numpy, (cx, ivx, cy, ivy, s, lx, ly)),
                                         gs, mode, interval)
    for key in KEYS + ("nmoves",):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    wm, gm = np.asarray(want["moves"]), got["moves"].numpy()
    for b in range(3):
        n = int(got["nmoves"][b])
        np.testing.assert_array_equal(gm[b, :n], wm[b, :n])
        assert not gm[b, n:].any()


def full_traceback(hs, lx, ly, gs, mode):
    out = scan.wavefront_dp(hs, lx, ly, gs, mode, traceback=True)
    moves, n = replay.replay_moves_plain(out["tb"], out["ti"], out["tj"], out["tcode"], gs,
                                         mode, steps=hs.shape[0] - 1)
    return out, moves, n


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gs,interval", [((11, 1), 8), ((13, 7, 1), 5), ((5,), 64)])
def test_blocks_rebuild_the_full_traceback(mode, gs, interval):
    """The forward pass's terminals are the traceback pass's, each resumed
    block is its rows of ``tb`` byte for byte, and ``replay_block_plain``
    over the blocks from the last to the first builds ``replay_moves``'s
    tape."""
    rng = np.random.default_rng(seed_of("blocks", mode, gs))
    cx, ivx, cy, ivy, lx, ly = map(torch.from_numpy, operands(rng, 4, 37, 29))
    hs = skewed_pair_scores(cx, ivx, cy, ivy, torch.from_numpy(B62.as_f32()))
    D, B, Lp = hs.shape
    full, want_moves, want_n = full_traceback(hs, lx, ly, gs, mode)
    out, snap = scan.forward_snapshots(hs, lx, ly, gs, mode, interval)
    for key in KEYS:
        assert torch.equal(out[key], full[key]), key
    assert snap.shape == (-(-(D - 2) // interval), B, tiled_dp.carry_values(len(gs)), Lp)
    state = replay.walk_state(out["ti"], out["tj"], out["tcode"], len(gs))
    moves = torch.zeros((B, D - 1), dtype=torch.uint8)
    for q in range(snap.shape[0] - 1, -1, -1):
        bits = tiled_dp.wavefront_dp_tiled_resume(hs, lx, ly, gs, mode, interval, q, snap)
        rows = min(interval, D - 2 - q * interval)
        assert torch.equal(bits[:rows], full["tb"][q * interval: q * interval + rows])
        replay.replay_block(bits, state, moves, q, gs, mode)
    assert torch.equal(state[5], want_n)
    assert torch.equal(moves, want_moves)


def test_snapshot_round_trips_the_carries():
    rec = scan.Recurrence((13, 7, 1), "local", True, 20)
    lane = torch.arange(9, dtype=torch.int32)[None, :]
    c = scan.carries_d1(rec, lane, 2)
    back = scan.unpack_carries(rec, scan.pack_carries(c))
    for key, v in c.items():
        if isinstance(v, list):
            assert all(torch.equal(a, b) for a, b in zip(v, back[key])), key
        else:
            assert torch.equal(v.to(back[key].dtype), back[key]), key
    assert scan.default_ckpt_interval(68_863) == 2112  # a titin pair: 33 blocks
    assert scan.default_ckpt_interval(10) == 64


def jax_pairs(rng, specs):
    def one(L):
        return JaxProfile.from_tokens(rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA)
    return [(one(a), one(b)) for a, b in specs]


def to_port(p):
    return profile_from_arrays(np.asarray(p.counts), np.asarray(p.gaps), ALPHABET_AA.symbols)


PORT_B62 = port_matrix("blosum62")
PORT_PAM = port_matrix("pam250")


@pytest.mark.parametrize("mode,gs", [("global", (11, 1)), ("semiglobal", (13, 7, 1)),
                                     ("local", (5,))])
def test_align_pairs_checkpointed_route_matches_jax(monkeypatch, mode, gs):
    """With the budgets patched low the chunks take the checkpointed route
    (no full traceback) and return the JAX package's results under the same
    patch."""
    monkeypatch.setattr(jax_batch, "_lane_cap", lambda gs, tb: 20)
    monkeypatch.setattr(jax_batch, "TB_BYTES_BUDGET", 64)
    monkeypatch.setattr(batch, "HS_BYTES_BUDGET", 64)
    monkeypatch.setattr(batch, "TB_BYTES_BUDGET", 64)
    rng = np.random.default_rng(seed_of("pairs", mode))
    pairs = jax_pairs(rng, [(25, 18), (31, 30), (25, 9), (12, 40)])
    want = jax_align_pairs(pairs, B62, gs, mode, traceback=True, bucket_sizes=(15,),
                           backend="pallas")
    assert batch.choose_route("cpu", 31, 31, True) == "checkpointed"
    batch.reset_route_counts()
    got = batch.align_pairs_batched([(to_port(a), to_port(b)) for a, b in pairs], PORT_B62, gs,
                                    mode, device="cpu", traceback=True, bucket_sizes=(15,))
    assert batch.checkpointed_chunks > 0 and sum(batch.route_counts.values()) == 0
    for w, g in zip(want, got):
        assert g.score == w.score
        np.testing.assert_array_equal(g.cols_x, w.cols_x)
        np.testing.assert_array_equal(g.cols_y, w.cols_y)


def test_budgets_scale_with_the_card(monkeypatch):
    """An 80 GB card multiplies the v5e budgets by its memory over 16 GiB;
    the CPU keeps them as written; LADDER_TOP stays the reference's."""
    monkeypatch.setattr(batch, "device_memory_bytes",
                        lambda device: H100_MEMORY if torch.device(device).type == "cuda"
                        else None)
    factor = H100_MEMORY / (16 << 30)
    assert batch._scaled_budget(batch.TB_BYTES_BUDGET, "cuda") == int((1 << 31) * factor)
    assert batch._scaled_budget(batch.HS_BYTES_BUDGET, "cpu") == 1 << 30
    assert dm.LADDER_TOP == 32767
    # titin (34,431 stepped) fits the scaled traceback budget; 75,000 nt does not
    assert batch.choose_route("cuda", 34431, 34431, True) == "tiled"
    assert batch.choose_route("cuda", 74999, 74999, True) == "checkpointed"
    assert batch.choose_route("cpu", 34431, 34431, True) == "checkpointed"
    # the tiled kernel keeps its hs source past 11,585 lanes, to about 25,800
    assert batch.tiled_source(20000, 20000, "cuda") == "hs"
    assert batch.tiled_source(20000, 20000, "cpu") == "rows"
    assert batch.tiled_source(26000, 26000, "cuda") == "rows"
    monkeypatch.setattr(batch, "TB_BYTES_BUDGET", 1 << 20)  # read at call time
    assert batch.choose_route("cuda", 34431, 34431, True) == "checkpointed"


def test_checkpoint_bytes_replace_the_traceback_in_chunk_sizing():
    full = batch.chunk_problem_bytes("tiled", "cuda", 34431, 34431, A, True)
    ckpt = batch.chunk_problem_bytes("checkpointed", "cuda", 34431, 34431, A, True, levels=2)
    tb = batch.per_problem_bytes(34431, 34431)[1]
    assert full - ckpt == 2 * tb - batch.checkpoint_bytes(34431, 34431, 2)
    # 33 snapshots of 14 carries a lane, one block of 2112 rows, the tape
    assert batch.checkpoint_bytes(34431, 34431, 2) == 33 * 14 * 34432 * 4 + 2112 * 34432 + 68862


def two_track_ops(rng, B, Lx, Ly):
    tracks = []
    for s in (B62, PAM):
        cx, ivx, cy, ivy, lx, ly = operands(rng, B, Lx, Ly)
        tracks.append(tuple(map(torch.from_numpy, (cx, ivx, cy, ivy, s.as_f32()))))
    return tracks, torch.from_numpy(lx), torch.from_numpy(ly)


def test_composite_source_scores_are_the_composite():
    rng = np.random.default_rng(7)
    tracks, lx, ly = two_track_ops(rng, 2, 11, 17)
    w = (1.0, 0.3)
    c = tiled_dp.Composite(*[tuple(t[i] for t in tracks) for i in range(5)], w)
    want = composite_skewed_scores(*[[t[i] for t in tracks] for i in range(5)], w)
    assert tiled_dp.source_kind(c) == "composite"
    assert torch.equal(tiled_dp.source_scores(c).view(torch.int32), want.view(torch.int32))
    got = tiled_dp.wavefront_dp_tiled(c, lx, ly, (11, 1), "local", True, tier="mma")
    full = scan.wavefront_dp(want, lx, ly, (11, 1), "local", True)
    for key in KEYS + ("tb",):
        assert torch.equal(got[key], full[key]), key


@pytest.mark.parametrize("traceback", [False, True])
def test_composites_past_the_budgets_match_jax(monkeypatch, traceback):
    """A composite past the hs budget takes the tiled route, and with its
    traceback past that budget the checkpointed route; results equal the
    JAX package's composite aligner."""
    monkeypatch.setattr(batch, "HS_BYTES_BUDGET", 64)
    monkeypatch.setattr(batch, "TB_BYTES_BUDGET", 64)
    rng = np.random.default_rng(seed_of("tracks", traceback))
    specs = [(21, 30), (40, 17), (33, 33)]
    a = jax_pairs(rng, specs)
    b = jax_pairs(rng, specs)
    pairs = [((pa, qa), (pb, qb)) for (pa, pb), (qa, qb) in zip(a, b)]
    w = (1.0, 0.5)
    want = jax_align_tracks(pairs, [B62, PAM], w, (11, 1), "semiglobal", traceback=traceback)
    port_pairs = [((to_port(x0), to_port(x1)), (to_port(y0), to_port(y1)))
                  for (x0, x1), (y0, y1) in pairs]
    assert batch.composite_route("cuda", 63, 63, traceback) == (
        "checkpointed" if traceback else "tiled")
    batch.reset_route_counts()
    got = batch.align_tracksets_batched(port_pairs, [PORT_B62, PORT_PAM], w, (11, 1),
                                        "semiglobal", device="cpu", traceback=traceback)
    if traceback:
        assert batch.checkpointed_chunks > 0
        for g, r in zip(got, want):
            assert g.score == r.score
            np.testing.assert_array_equal(g.cols_x, r.cols_x)
            np.testing.assert_array_equal(g.cols_y, r.cols_y)
    else:
        assert batch.route_counts["tiled"] > 0
        assert [(g.score, g.length) for g in got] == [(r.score, r.length) for r in want]
