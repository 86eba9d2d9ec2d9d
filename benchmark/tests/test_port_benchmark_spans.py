"""The readers of the program's spans and counters: a traced tiny run of
each cell on the CPU reports them, the batch drivers' cell share is the
one the families' lengths and their bucket give, and an idle reader reads
0.0 where no gap falls in its spans."""

import itertools
import time

import pytest

from benchmark import families, harness, tracing
from praline_tpu_torch import METRICS

from .port_benchmark_cells import TINY, tiny_cell

IDLE = ("dispatch.idle_s", "batch.host_idle_s", "merge.host_idle_s")
NEW = {"default.allpairs192": {"dispatch.idle_s", "batch.host_idle_s", "batch.cell_share"}}
NEW["default.msa128"] = NEW["default.allpairs192"] | {"merge.host_idle_s", "merge.cell_share"}


@pytest.mark.parametrize("workload", ["default.msa128", "default.allpairs192"])
def test_a_traced_run_reports_the_span_and_counter_metrics(workload):
    cell = tiny_cell(workload)
    METRICS.counters.clear()
    line = harness.run(cell, 2**31 + 29, 0.3, True, "cpu", time.perf_counter(),
                       log=lambda *a, **k: None)
    assert line["correct"] is True
    assert {m["name"] for m in cell.readers(per_layer=True)} & NEW["default.msa128"] == \
        NEW[workload]
    assert NEW[workload] <= set(line["metrics"]), line["metrics"]
    # every family of every seed has the same lengths, all in the 63-lane bucket
    lengths = families.target_lengths(TINY["members"], TINY["lo"], TINY["hi"])
    pairs = list(itertools.combinations(lengths.tolist(), 2))
    share = 100.0 * sum(a * b for a, b in pairs) / (len(pairs) * 63 * 63)
    assert line["metrics"]["batch.cell_share"]["value"] == pytest.approx(share, rel=1e-12)
    if workload == "default.msa128":
        assert 0.0 < line["metrics"]["merge.cell_share"]["value"] <= 100.0


def test_idle_readers_sum_their_spans_gaps_over_the_traced_requests():
    cell = tiny_cell("default.msa128")
    records = [harness.Record(k, 0.1, 0.0, 1, {}, {}, k > 0) for k in range(3)]
    run = harness.Run(cell, 1.0, 2.0, records, None, 0, {})
    run.trace = tracing.Trace(1.0, 0.5, {}, {"all_pairs / python": 0.2,
                                             "harness / python": 0.1,
                                             "progressive_merge / aten::copy_": 0.05})
    for name in IDLE:
        assert harness.reader(cell.bench, name)(run) == 0.0
    run.trace.gaps.update({"dispatch:63x63x15 / python": 0.3,
                           "dispatch:sharded:63x63x15:shard0/2 / aten::empty": 0.1,
                           "batch:unpack / python": 0.04, "merge:assemble / python": 0.5,
                           "merge:table / aten::copy_": 0.1})
    got = {name: harness.reader(cell.bench, name)(run) for name in IDLE}
    assert got == pytest.approx({"dispatch.idle_s": 0.2, "batch.host_idle_s": 0.02,
                                 "merge.host_idle_s": 0.3})
    run.trace = None
    assert all(harness.reader(cell.bench, name)(run) is None for name in IDLE)
