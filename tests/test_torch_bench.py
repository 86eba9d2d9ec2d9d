"""The port's benchmark module (``praline_tpu_torch.bench``) on the CPU.

Every config runs at tiny sizes on the CPU and must print the keys the
root ``bench.py`` prints for it (read from ``bench.py``'s text, its
``vmem_*`` keys named ``smem_*`` in the port: the Hopper counterpart of
VMEM is shared memory; ``vmem_utilization`` has no counterpart, as the
port's DP moves no stream of bytes through shared memory).  The
``wprobe`` config holds every tensor it writes against ``x``.  The ``tracks`` workload through the port gives
the JAX package's results.  The op counter behind ``dp_lane_ops_per_step``
counts a known function exactly, ``ring`` and ``scaling`` run through
``main`` and print one line, and the default device is the card.
"""

import ast
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from praline_tpu import builtin_score_matrix as jax_matrix
from praline_tpu.kernels import align_tracksets_batched as jax_tracksets
from praline_tpu.types import Profile as JaxProfile
from praline_tpu_torch import bench
from praline_tpu_torch.kernels import batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HEADLINE = dict(B=8, L=31, iters=1, nprof=8)
TINY = {
    "cells": dict(B=8, L=31, iters=2, nprof=8),
    "utilization": dict(smem_shape=(4, 8), smem_links=10, alu_shape=(4, 8), alu_links=10,
                        dp_batch=4, L=31, reps=1, headline=HEADLINE),
    "pairwise": dict(L=40),
    "allpairs100": dict(n=5, L=30),
    "tracks": dict(nprof=4, n_pairs=6, L=31, iters=2),
    "msa": dict(n=5, L=30),
    "preprofile": dict(n=5, L=30),
    "modes": dict(n=6, L=30),
    "scaling": dict(B=10, L=15, nprof=4, runs=1),
    "ring": dict(Lx=40, Ly=30, intervals=(1, 8), ckpt=(8, 16), runs=1),
    "wprobe": dict(shape=(4, 256, 256), blocks={"2x128x128": (2, 128, 128)}, hs_bucket=31,
                   hs_batches=(2, 3), reps=1),
}
# The root bench.py's function for each config.
ROOT_FUNCTION = {"cells": "bench", "utilization": "bench_utilization",
                 "pairwise": "bench_pairwise", "allpairs100": "bench_allpairs100",
                 "tracks": "bench_tracks", "msa": "bench_msa", "preprofile": "bench_msa",
                 "modes": "bench_modes", "scaling": "bench_scaling", "ring": "bench_ring"}


@functools.lru_cache(maxsize=1)
def root_keys() -> dict[str, set[str]]:
    """The string keys of the dict each top-level function of ``bench.py``
    returns last."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef):
            returns = [n for n in fn.body if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
            if returns:
                keys[fn.name] = {k.value for k in returns[-1].value.keys}
    return keys


@pytest.mark.parametrize("config", sorted(TINY))
def test_config_runs_tiny_with_bench_keys(config):
    assert set(TINY) == set(bench.CONFIGS)
    out = bench.CONFIGS[config]("cpu", **TINY[config])
    json.dumps(out)
    if config in ROOT_FUNCTION:
        want = {k.replace("vmem", "smem") for k in root_keys()[ROOT_FUNCTION[config]]
                if k != "vmem_utilization"}
    else:
        want = {"metric", "value", "unit", "vs_baseline"}
    assert want <= set(out), want - set(out)
    assert out["device"] == "cpu"
    assert np.isfinite(out["value"])


def test_utilization_counts_the_port_dp():
    out = bench.bench_utilization("cpu", **TINY["utilization"])
    assert out["dp_lane_ops_per_step"] == bench.count_step_lane_ops()
    assert out["dp_ops_per_cell"] == out["dp_lane_ops_per_step"] * out["dp_lane_slots_per_cell"]
    # lengths 15..31 in bucket 31: (lx + ly - 1) * 32 slots for lx * ly cells
    assert 1.0 < out["dp_lane_slots_per_cell"] < 32 * 61 / (15 * 15)
    assert 4.0 < out["dp_bytes_per_cell"] < 4.2


def test_wprobe_reports_each_pattern():
    out = bench.bench_wprobe("cpu", **TINY["wprobe"])
    assert set(out["blocks"]) == {"2x128x128"}
    assert set(out["hs_pattern"]) == {"B2", "B3"} and out["hs_pattern"]["B3"]["shape"] == [63, 3, 32]
    assert out["value"] == out["hs_pattern"]["B3"]["bytes_per_s"]
    assert set(bench.WPROBE_BLOCKS.values()) == {(16, 128, 128), (8, 128, 1024), (4, 128, 1024),
                                                 (16, 128, 512)}
    x = torch.tensor([[-0.0]])
    t = torch.full((5, 3, 4), -0.0)
    bench.assert_filled(t, x, "t")
    bench.assert_filled(t.permute(1, 0, 2), x, "t")
    t[4, 2, 3] = 0.0  # equal as a number, not bit for bit
    with pytest.raises(AssertionError, match="slab 0"):
        bench.assert_filled(t, x, "t")


def test_tracks_workload_gives_the_jax_results():
    sets, cells, mats, w = bench.tracks_workload(nprof=4, n_pairs=6, L=31)
    assert cells[0] == sum(float(tx[0].length) * ty[0].length for tx, ty in sets[0])
    port = batch.align_tracksets_batched(sets[0], mats, w, (11, 1), "global", device="cpu",
                                         bucket_sizes=(31,))

    def conv(p):
        return JaxProfile(p.counts, p.gaps, jax_matrix("blosum62").alphabet)

    jax_pairs = [(tuple(map(conv, tx)), tuple(map(conv, ty))) for tx, ty in sets[0]]
    ref = jax_tracksets(jax_pairs, [jax_matrix(m.name) for m in mats], w, (11, 1), "global",
                        bucket_sizes=(31,))
    for r, j in zip(port, ref):
        assert (r.score, r.length, r.ti, r.tj) == (j.score, j.length, j.ti, j.tj)


def test_lane_op_counter_counts_a_known_function():
    B, Lp = 4, 16
    a, b = torch.randn(B, Lp), torch.randn(B, Lp)
    with bench.LaneOpCounter(B * Lp) as counter:
        c = a * 2.0                          # 1 row
        d = torch.where(c > b, c, b - 1.0)   # 3 rows: gt, sub, where
        d.to(torch.int32)                    # a conversion: not counted
        e = torch.empty_like(d)              # an allocation and copies: not counted
        e[:, 0] = 1.0
        e[:, 1:] = d[:, :-1]
        d[:, : Lp // 2] + 1.0                # half a row
        torch.maximum(e, d).max(dim=1)       # 1 row, then B values and B indices
    assert counter.rows == 1 + 3 + 0.5 + 1 + 2 * B / (B * Lp)
    assert bench.count_step_lane_ops() > 10


def test_scaling_and_ring_exit_nonzero(capsys, monkeypatch):
    """``ring`` (``dist/ring.py``, ported) runs through ``main`` on 8 CPU
    shards at TINY's size and prints one JSON line with the root
    ``bench_ring``'s keys, from a fresh interpreter too; ``scaling`` runs on
    the pair mesh (tiny here) and prints one JSON line."""
    monkeypatch.setitem(bench.CONFIGS, "ring", functools.partial(bench.bench_ring, **TINY["ring"]))
    assert bench.main(["ring", "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    out = json.loads(line)
    assert root_keys()["bench_ring"] <= set(out) and out["shards"] == 8 and out["ranks"] == 1
    assert set(out["wallclock_s"]) == {"interval_1", "interval_8"}
    assert out["ckpt_traceback_moves"] >= TINY["ring"]["Lx"] and out["device"] == "cpu"
    code = ("import sys, functools; from praline_tpu_torch import bench; "
            f"bench.CONFIGS['ring'] = functools.partial(bench.bench_ring, **{TINY['ring']!r}); "
            "sys.exit(bench.main(['ring', '--device', 'cpu']))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout)["metric"] == "ring_superstep_speedup"
    monkeypatch.setitem(bench.CONFIGS, "scaling",
                        functools.partial(bench.bench_scaling, **TINY["scaling"]))
    assert bench.main(["scaling", "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    out = json.loads(line)
    assert out["metric"] == "scaling_efficiency" and set(out["wallclock_s"]) == {"1", "2", "4", "8"}
    assert out["parallel_efficiency"] == out["value"] == out["efficiency"]["8"]
    one = bench.bench_scaling("cpu", **dict(TINY["scaling"], shard_counts=(1,)))
    assert one["metric"] == "sharded_allpairs_wallclock" and "parallel_efficiency" not in one


def test_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setitem(bench.CONFIGS, "pairwise", functools.partial(bench.bench_pairwise, L=20))
    assert bench.main(["pairwise", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["metric"] == "pairwise_global_wallclock"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            bench.main(["pairwise"])
