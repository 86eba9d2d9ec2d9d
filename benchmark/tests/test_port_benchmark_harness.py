"""The harness on the CPU: generator, work count, discovery, the result line."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import families, harness, roofline
from benchmark.reference import msa as ref

from .port_benchmark_cells import ROOT, TINY, tiny_cell


def test_families_repeat_and_seeds_change_only_residues():
    p = dict(TINY, members=12)
    a = families.family(2**31 + 5, 3, p)
    assert all(np.array_equal(x, y) for x, y in zip(a, families.family(2**31 + 5, 3, p)))
    b = families.family(7, 3, p)
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))
    want = sorted(families.target_lengths(12, p["lo"], p["hi"]))
    assert sorted(len(t) for t in a) == sorted(len(t) for t in b) == want
    assert all(t.dtype == np.int32 and t.min() >= 0 and t.max() < 20 for t in a)


def test_needed_cells_equal_a_brute_force_sum():
    msa_cell = tiny_cell("default.msa128")
    tokens = families.family(1, 0, TINY)
    S = harness.score_matrix(msa_cell.bench, msa_cell.config)
    joins = ref.guide_tree(*ref.all_pairs(tokens, S, (11, 1), "global", "cpu"),
                           "average", "length")
    rows = ref.progressive_merge(tokens, joins, S, (11, 1), "global", "cpu")
    entry = harness.Entry(msa_cell, S, "cpu")
    try:
        needed = entry.needed(tokens)
        merge = entry.merge_work(tokens, {"rows": rows, "joins": joins})
        assert entry.merge_work(tokens, {"all_pairs": None}) is None
    finally:
        entry.close()
    assert needed.cells == sum(len(tokens[i]) * len(tokens[j])
                               for i in range(6) for j in range(i + 1, 6))
    want, members = 0, {i: [i] for i in range(6)}
    for k, (l, r) in enumerate(joins):
        width = lambda m: int((rows[m] != ref.GAP).any(axis=0).sum())
        want += width(members[l]) * width(members[r])
        members[6 + k] = members.pop(l) + members.pop(r)
    assert merge.cells == want


def test_bound_takes_the_larger_of_operations_and_bytes():
    w = roofline.Work()
    w.add_problems(1e6, 2000, 1, 23, 24.0, False)
    rates = {"f32_ops_per_s": 1e12}
    assert roofline.bound_s(w, rates) == pytest.approx(24e6 / 1e12 + 46e6 / roofline.INT8_OPS_PER_S)
    w.nbytes = 1e12
    assert roofline.bound_s(w, rates) == pytest.approx(1e12 / roofline.HBM_BYTES_PER_S)


def test_cells_configs_and_metrics_come_from_files_alone(tmp_path):
    """A new configuration, traffic mix and per-layer metric are files the
    harness finds by name; no code changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "benchmark/configs/praline-default.json").read_text())
    (bench / "configs/praline-other.json").write_text(json.dumps(dict(config, linkage="single")))
    (bench / "traffic/msa6.json").write_text(json.dumps(
        {"entry": "msa_align", "family": TINY, "pool": 2, "check_requests": 1,
         "trace_requests": 1}))
    (bench / "metrics/requests_done.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    spec["configs"].append({"name": "praline-other", "source": "x",
                            "file": "benchmark/configs/praline-other.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "other.msa6", "config": "praline-other",
                              "traffic": "msa6", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "pipeline",
                              "moves": "dp_cells_per_s", "workloads": ["other.msa6"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell(tmp_path, "other.msa6", bench)
    assert cell.config["linkage"] == "single" and cell.traffic["family"] == TINY
    names = [m["name"] for m in cell.readers(per_layer=True)]
    assert "requests_done" in names and "stage.merge_s" not in names
    run = harness.Run(cell, 1.0, 2.0, [object(), object()], None, 0, {})
    assert harness.reader(bench, "requests_done")(run) == 2.0
    assert "requests_done" not in [m["name"] for m in harness.find_cell(
        tmp_path, "default.msa128", bench).metrics]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    msa_cell = tiny_cell("default.msa128")
    line = harness.run(msa_cell, 2**31 + 11, 0.3, trace, "cpu", time.perf_counter(),
                       log=lambda *a, **k: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in msa_cell.readers(per_layer=trace)}
    got = set(line["metrics"])
    assert got <= want and all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"stage.all_pairs_s", "stage.merge_s", "batch.chunks", "host.gc_s"} <= got
    else:
        assert {"dp_cells_per_s", "family_s_p90", "setup_s"} == got
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())


def test_all_pairs_cell_checks_its_matrices():
    pairs_cell = tiny_cell("default.allpairs192")
    line = harness.run(pairs_cell, 3, 0.2, False, "cpu", time.perf_counter(),
                       log=lambda *a, **k: None)
    assert line["correct"] is True
    assert set(line["checks"]) == {"pairs_differ", "requests_failed"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "praline_tpu_torch_like", sys)
    assert "praline_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "praline_tpu.msa", sys)
    assert harness.forbidden_modules() == ["praline_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark import harness\n"
            "from benchmark.tests.port_benchmark_cells import tiny_cell\n"
            "harness.run(tiny_cell('default.msa128'), 1, 0.1, True, 'cpu', time.perf_counter(),"
            " log=lambda *a, **k: None)\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_benchmark_source_names_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace("(", " ").replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in harness.FORBIDDEN, f"{path}: {line}"


@pytest.mark.requires_cuda
def test_each_cell_runs_correct_on_the_card():
    """On the card: every cell of BENCHMARK.json, a two-second window, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w["name"],
                              "--seed", "3", "--seconds", "2", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True and line["device"]["platform"] == "gpu", line
