"""The check that decides ``correct``: the reference against the port's CPU
path, the control in lower precision, and runs with the timed path broken."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark import control, families, harness
from benchmark.reference import msa as ref

from .port_benchmark_cells import TINY, tiny_cell


def quiet(*args, **kwargs):
    pass


def test_reference_agrees_with_the_port_on_the_cpu():
    """The port's CPU path and the reference: the same matrices, tree and
    rows (so the same emitted FASTA)."""
    msa_cell = tiny_cell("default.msa128")
    tokens = families.family(9, 0, TINY)
    S = harness.score_matrix(msa_cell.bench, msa_cell.config)
    entry = harness.Entry(msa_cell, S, "cpu")
    try:
        out = entry(entry.sequences(tokens))
    finally:
        entry.close()
    scores, lengths = ref.all_pairs(tokens, S, (11, 1), "global", "cpu")
    np.testing.assert_array_equal(out["all_pairs"][0], scores)
    np.testing.assert_array_equal(out["all_pairs"][1], lengths)
    joins = ref.guide_tree(scores, lengths, "average", "length")
    assert joins == out["joins"]
    rows = ref.progressive_merge(tokens, joins, S, (11, 1), "global", "cpu")
    np.testing.assert_array_equal(rows, out["rows"])
    assert ref.judge(tokens, out, S, msa_cell.config, "cpu") == {
        "pairs_differ": 0, "tree_joins_differ": 0, "alignment_errors": 0}


@pytest.mark.parametrize("workload", ["default.msa128", "default.allpairs192"])
def test_the_control_fails_the_check(workload):
    """The reference in bfloat16 in the program's place, at lengths whose
    scores pass bfloat16's exact integers (256): some number passes its limit."""
    cell = tiny_cell(workload)
    cell.traffic["family"] = dict(TINY, root=200, lo=160, hi=200)
    got = control.readings(cell, 5, "cpu", 1)
    limits = harness.load_json(cell.bench / "data" / "checks.json")["limits"]
    assert any(v > limits[k] for k, v in got.items()), got
    same = control.readings(cell, 5, "cpu", 1, torch.float32)
    assert all(v == 0 for v in same.values()), same


def _results_unchanged(fn):
    """The DP returns its starting state: every score and length 0."""
    def broken(pairs, *args, **kwargs):
        return [dataclasses.replace(r, score=0.0, length=0) for r in fn(pairs, *args, **kwargs)]
    return broken


def _half_left_out(fn):
    """Only the first half of the batch is computed; its results stand in for the rest."""
    def broken(pairs, *args, **kwargs):
        half = fn(pairs[:(len(pairs) + 1) // 2], *args, **kwargs)
        return half + half[:len(pairs) - len(half)]
    return broken


def _one_score_altered(fn):
    def broken(pairs, *args, **kwargs):
        out = fn(pairs, *args, **kwargs)
        out[len(out) // 2] = dataclasses.replace(out[len(out) // 2],
                                                 score=out[len(out) // 2].score + 1.0)
        return out
    return broken


def _one_column_moved(fn):
    """The merged alignment with one residue moved into a neighbouring gap
    column: every row still degaps to its input."""
    def broken(*args, **kwargs):
        aln = fn(*args, **kwargs)
        rows = np.asarray(aln.rows).copy()
        for r, row in enumerate(rows):
            hits = np.flatnonzero((row[:-1] != -1) & (row[1:] == -1))
            if hits.size:
                c = hits[0]
                rows[r, c], rows[r, c + 1] = -1, row[c]
                break
        return type(aln)(aln.members, rows)
    return broken


FAULTS = {
    "state_unchanged": ("align_pairs_batched", _results_unchanged),
    "half_left_out": ("align_pairs_batched", _half_left_out),
    "answer_altered_score": ("align_pairs_batched", _one_score_altered),
    "answer_altered_column": ("try_device_merge", _one_column_moved),
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("default.msa128", "default.allpairs192") for f in sorted(FAULTS)
    if w == "default.msa128" or FAULTS[f][0] != "try_device_merge"])  # no merge in the distance stage
def test_a_broken_timed_path_reads_not_correct(monkeypatch, workload, fault):
    """A run (past the harness's look for a card) with the program broken
    underneath the window: ``correct`` comes out false."""
    from praline_tpu_torch.msa import pipeline

    name, breaker = FAULTS[fault]
    monkeypatch.setattr(pipeline, name, breaker(getattr(pipeline, name)))
    line = harness.run(tiny_cell(workload), 21, 0.2, False, "cpu", time.perf_counter(),
                       log=quiet)
    assert line["correct"] is False, line["checks"]
