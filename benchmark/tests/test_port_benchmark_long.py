"""The long routes against the plain reference on the CPU: a tiny family of
``dhc1.msa64``'s shape (6 members of 40-64 residues) with the lane caps
forced down, so that the all-pairs stage takes the fused and the tiled
route and the merge's rung the tiled route with traceback, as 4092-4646
residues do on the card; and the problems ``kernel.tiled.roofline_share``
counts are those the program's counters say the tiled route ran."""

import time

import pytest

from benchmark import families, harness, roofline, tracing
from benchmark.reference import msa as ref
from praline_tpu_torch import METRICS
from praline_tpu_torch.kernels import batch, wavefront

from .port_benchmark_cells import ROOT

CAP = 63  # the forced fused kernel's largest row
SEED = 2**31 + 3


@pytest.fixture
def long_cell(monkeypatch):
    """``dhc1.msa64`` with families of 6 members of 40-64 residues (its
    traffic's substitution and indels), the whole-row DP capped at 31
    lanes and the fused kernel at 63."""
    monkeypatch.setattr(wavefront, "MAX_LANES", 32)
    monkeypatch.setattr(batch, "MAX_LANES_FUSED", CAP + 1)
    monkeypatch.setattr(batch, "ROUTE_CAP_BUCKETS", (31, CAP))
    monkeypatch.delenv(batch.FUSED_DP_ENV, raising=False)
    cell = harness.find_cell(ROOT, "dhc1.msa64")
    family = dict(cell.traffic["family"], members=6, root=64, lo=40, hi=64)
    cell.traffic = dict(cell.traffic, family=family, pool=3, check_requests=2, trace_requests=1)
    return cell


def tiled_reader(cell):
    read = harness.reader(cell.bench, "kernel.tiled.roofline_share")
    read.__globals__["CAP"] = CAP
    return read


def test_long_routes_agree_with_the_reference(long_cell):
    cell = long_cell
    tokens = families.family(SEED, 0, cell.traffic["family"])
    assert max(len(t) for t in tokens[:-1]) > CAP  # some pair's x passes the fused cap
    S = harness.score_matrix(cell.bench, cell.config)
    entry = harness.Entry(cell, S, "cpu")
    try:
        batch.reset_route_counts()
        before = dict(METRICS.counters)
        out = entry(entry.sequences(tokens))
        grown = {k: v - before.get(k, 0) for k, v in METRICS.counters.items()}
        notes, routes = dict(METRICS.notes), dict(batch.route_counts)
        merge = entry.merge_work(tokens, out)
    finally:
        entry.close()
    assert ref.judge(tokens, out, S, cell.config, "cpu") == {
        "pairs_differ": 0, "tree_joins_differ": 0, "alignment_errors": 0}
    assert routes["fused"] > 0 and routes["tiled"] > 0 and routes["two_kernel"] == 0
    assert notes["merge_route"] == "tiled" and len(notes["merge_attempts"]) == 1
    assert grown["batch.cells_needed:fused"] > 0
    assert grown.get("batch.cells_needed:two_kernel", 0) == 0

    record = harness.Record(0, 0.0, 0.0, 0, {}, notes, True, out)
    run = harness.Run(cell, 0.0, 1.0, [record], None, 0, {})
    work, pairs, joins = tiled_reader(cell).__globals__["tiled_work"](run, [record])
    assert pairs == grown["tiled.problems:scores"] > 0
    assert joins == grown["tiled.problems:traceback"] == len(tokens) - 1
    assert grown["tiled.chunks:hs"] == routes["tiled"]
    assert work.cells == grown["batch.cells_needed:tiled"] + merge.cells


def test_a_traced_long_run_reports_its_metrics(long_cell):
    """A traced run of the tiny long cell is correct and reads the idle
    under the long routes' spans and the long routes' share of the cells;
    the roofline share has no device kernel to read on the CPU."""
    line = harness.run(long_cell, SEED, 0.3, True, "cpu", time.perf_counter(),
                       log=lambda *a, **k: None)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["tiled.host_idle_s"]["value"] > 0.0
    assert 0.0 < metrics["batch.long_cell_share"]["value"] <= 100.0
    assert "kernel.tiled.roofline_share" not in metrics


def test_the_tiled_roofline_reads_k6_launches_alone(long_cell):
    """The bound of the K6 problems over the device time of the tiled walk's
    instances, not the whole-row walk's (``HsSource, 2, true, 128``)."""
    cell = long_cell
    tokens = families.family(SEED, 1, cell.traffic["family"])
    S = harness.score_matrix(cell.bench, cell.config)
    entry = harness.Entry(cell, S, "cpu")
    try:
        out = entry(entry.sequences(tokens))
    finally:
        entry.close()
    record = harness.Record(1, 0.0, 0.0, 0, {}, {}, True, out)
    rates = {"f32_ops_per_s": 3.3454e13}
    kernels = {
        "void praline_dp::walk_kernel<praline_dp::HsSource, 2, false, 512, 1, false, false>"
        "(praline_dp::WalkArgs, praline_dp::HsSource)": 0.002,
        "void praline_dp::walk_kernel<praline_dp::HsSource, 2, true, 128, 4, false, false>"
        "(praline_dp::WalkArgs, praline_dp::HsSource)": 5.0,
        "void praline_dp::walk_kernel<praline_dp::HsSource, 2, false, 512, 1, true, false>"
        "(praline_dp::WalkArgs, praline_dp::HsSource)": 0.001}
    run = harness.Run(cell, 0.0, 1.0, [record], rates, 0, {},
                      tracing.Trace(1.0, 0.5, kernels, {}))
    read = tiled_reader(cell)
    work, _, _ = read.__globals__["tiled_work"](run, [record])
    assert read(run) == pytest.approx(100.0 * roofline.bound_s(work, rates) / 0.003)
    run.trace = tracing.Trace(1.0, 0.5, {}, {})
    assert read(run) is None
