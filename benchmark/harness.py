"""One run of one cell: set-up, the measured window, the check, the result line.

Everything that belongs to one cell is found by name from ``BENCHMARK.json``:
the cell names a configuration (its file holds PRALINE's settings) and a
traffic mix (``traffic/<name>.json``: the entry point, the family
parameters, how many families to make, check and trace); every metric is a
reader ``metrics/<metric name>.py`` with ``read(run) -> float | None``; the
kernels each layer owns are patterns in ``data/kernel_layers.json``; the
limits of the numbers compared for ``correct`` are in ``data/checks.json``.

A run is a closed loop with one client: a request (one family) starts when
the one before it has ended, from the start of the window until
``seconds`` have passed; the window ends when the last request started in
it ends.  Requests are timed from their call until their result is on the
host.  With ``--trace 1``, ``trace_requests`` more requests run under
``torch.profiler`` once the window has closed; the program's counters are
read from the window's requests.  A request that takes ten times a warm request
or more is logged with its stage clock, its host counters and the card's
allocator state.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import re
import resource
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from . import families, roofline, tracing
from .reference import msa as ref

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "praline_tpu")
WARMUP_REQUESTS = 2
SLOW = 10  # a request this many times the last warm-up's wall is logged in full
STAGES = ("batched_preprofiles", "batched_all_pairs", "build_guide_tree",
          "batched_progressive_merge")  # the pipeline's stage calls, each in a profiler range


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list  # the BENCHMARK.json entries of this cell's end-to-end and per-layer metrics
    bench: Path  # the folder of traffic files, metric readers and data

    def readers(self, per_layer: bool) -> list:
        return [m for m in self.metrics if m["per_layer"] == per_layer]


def find_cell(root: Path, name: str, bench: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its configuration,
    traffic and metrics loaded from their files (traffic, readers and data
    under ``bench``)."""
    spec = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    metrics = [dict(m, per_layer=per_layer) for key, per_layer in (("end_to_end", False),
                                                                   ("per_layer", True))
               for m in spec[key] if name in m.get("workloads", [name])]
    return Cell(name, int(w["chips"]), load_json(root / cfg["file"]),
                load_json(bench / "traffic" / f"{w['traffic']}.json"), metrics, bench)


def reader(bench: Path, name: str):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def score_matrix(bench: Path, config: dict) -> np.ndarray:
    """The configuration's matrix file (NCBI format) over its alphabet's symbols."""
    lines = [ln.split() for ln in (bench / "data" / config["matrix"]).read_text().splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    cols = lines[0]
    table = {(row[0], c): int(v) for row in lines[1:] for c, v in zip(cols, row[1:])}
    symbols = config["alphabet"]
    return np.array([[table[(a, b)] for b in symbols] for a in symbols], dtype=np.int32)


class GcClock:
    """Seconds Python's garbage collector ran while registered (through
    ``gc.callbacks``).  Copied from ``chip_smoke.py::GcClock``."""

    def __init__(self):
        self.seconds = 0.0
        self._start = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._start

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


@dataclasses.dataclass
class Record:
    """One request of the window."""

    index: int  # the family's index in the pool
    wall_s: float
    gc_s: float
    chunks: int
    stages: dict
    notes: dict  # what the pipeline chose (METRICS.notes: the merge's rung and attempts)
    traced: bool
    output: object = None
    work: roofline.Work | None = None  # the all-pairs cells, from the inputs alone
    merge: roofline.Work | None = None  # the merge's joins, at the emitted profiles' widths


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    requests: list
    rates: dict
    peak_window_bytes: int
    layers: dict
    trace: tracing.Trace | None = None

    def counted(self) -> list:
        """The window's requests, which the program's counters are read from."""
        return [r for r in self.requests if not r.traced]

    def work(self, requests=None, merge=False) -> roofline.Work:
        total = roofline.Work()
        for r in self.counted() if requests is None else requests:
            total += r.work
            if merge and r.merge is not None:
                total += r.merge
        return total


class Entry:
    """The port's entry point a traffic mix drives, and what the harness
    needs around it: the request, its stage seconds and its needed work."""

    def __init__(self, cell: Cell, S: np.ndarray, device: str):
        import praline_tpu_torch as port
        from praline_tpu_torch.kernels import batch
        from praline_tpu_torch.msa import pipeline

        self.port, self.batch, self.pipeline = port, batch, pipeline
        c = cell.config
        if port.ALPHABET_AA.symbols != tuple(c["alphabet"]):
            raise SystemExit("the configuration's alphabet is not the program's protein alphabet")
        self.S, self.A, self.device = S, S.shape[0], device
        self.kind = cell.traffic["entry"]
        self.gaps = tuple(c["gap_series"])
        self.config = port.PralineConfig(
            gap_series=self.gaps, merge_mode=c["merge_mode"], distance_mode=c["distance_mode"],
            preprofile_mode=c["preprofile_mode"], linkage=c["linkage"],
            score_normalization=c["score_normalization"])
        self.matrix = port.ScoreMatrix(c["matrix"], S, port.ALPHABET_AA)
        self.captured: dict = {}
        self.stage_clock: dict = {}
        self.originals = {name: getattr(pipeline, name) for name in STAGES}
        for name, fn in self.originals.items():
            setattr(pipeline, name, self._ranged(name, fn))
        self.numbers = ("pairs_differ",) + (("tree_joins_differ", "alignment_errors")
                                             if self.kind == "msa_align" else ())

    def close(self) -> None:
        for name, fn in self.originals.items():
            setattr(self.pipeline, name, fn)

    def _ranged(self, name, fn):
        """``fn`` inside a profiler range of its stage's name; the all-pairs
        matrices kept for the check."""
        from torch.profiler import record_function

        label = name.replace("batched_", "").replace("build_", "")

        def wrapped(*args, **kwargs):
            with record_function(label):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.stage_clock[label] = time.perf_counter() - t0
            if name == "batched_all_pairs":
                self.captured["all_pairs"] = out
            return out

        return wrapped

    def sequences(self, tokens: list) -> list:
        port = self.port
        return [port.Sequence(f"s{k:03d}", t, port.ALPHABET_AA) for k, t in enumerate(tokens)]

    def __call__(self, seqs: list):
        """One request; its output on the host."""
        self.captured.clear()
        self.stage_clock.clear()
        if self.kind == "msa_align":
            trees = []
            aln = self.port.msa_align(seqs, self.matrix, self.config, device=self.device,
                                      on_tree=trees.append)
            return {"rows": np.asarray(aln.rows), "joins": tuple(trees[0].joins),
                    "all_pairs": self.captured["all_pairs"]}
        with_profiles = self.pipeline.batched_preprofiles(seqs, self.matrix, self.config,
                                                          device=self.device)
        return {"all_pairs": self.pipeline.batched_all_pairs(with_profiles, self.matrix,
                                                             self.config, device=self.device)}

    def chunks(self) -> int:
        return int(sum(self.batch.route_counts.values()) + self.batch.checkpointed_chunks)

    def needed(self, tokens: list) -> roofline.Work:
        """The all-pairs work the request needs, from its inputs alone: every
        pair of members at true lengths."""
        lengths = np.array([len(t) for t in tokens], dtype=np.float64)
        n = len(tokens)
        work = roofline.Work()
        work.add_problems(float((lengths.sum() ** 2 - (lengths ** 2).sum()) / 2), lengths.sum(),
                          n * (n - 1) // 2, self.A,
                          roofline.lane_ops(self.gaps, self.config.distance_mode, False), False)
        return work

    def merge_work(self, tokens: list, output) -> roofline.Work | None:
        """The merge's DP work: every join at its children's column counts in
        the emitted alignment.  It depends on the program's tree and paths,
        so only the kernels' roofline reads it, never ``dp_cells_per_s``."""
        if "rows" not in output:
            return None
        n = len(tokens)
        filled = output["rows"] != ref.GAP
        cols = {i: filled[i] for i in range(n)}
        ops = roofline.lane_ops(self.gaps, self.config.merge_mode, True)
        work = roofline.Work()
        for k, (l, r) in enumerate(output["joins"]):
            cl, cr = int(cols[l].sum()), int(cols[r].sum())
            work.add_problems(float(cl) * cr, cl + cr, 1, self.A, ops, True)
            cols[n + k] = cols.pop(l) | cols.pop(r)
        return work


def checked_requests(records: list, seed: int, count: int) -> list:
    """The requests the check compares: of the window's, the one that needed
    the most cells, and ``count - 1`` others drawn from the seed."""
    if not records:
        return []
    first = max(records, key=lambda r: r.work.cells)
    rest = [r for r in records if r is not first]
    rng = np.random.default_rng([seed, 1 << 32])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [first] + [rest[int(k)] for k in pick]


def window_summary(records: list, window_s: float) -> str:
    """One line on the window's requests, for the reader of a run's errors."""
    walls = np.array([r.wall_s for r in records]) if records else np.zeros(1)
    attempts = {}
    for r in records:
        key = "/".join(map(str, r.notes.get("merge_attempts", []))) or "none"
        attempts[key] = attempts.get(key, 0) + 1
    return (f"[window] requests={len(records)} window_s={window_s!r} wall_s "
            f"min={walls.min():.4f} median={np.median(walls):.4f} "
            f"p90={np.percentile(walls, 90):.4f} max={walls.max():.4f} "
            f"gc_s={sum(r.gc_s for r in records):.4f} merge_attempts={json.dumps(attempts)} "
            f"walls={','.join(f'{w:.4f}' for w in walls)}")


def host_state() -> str:
    """The host's load, free memory and this process's resident size."""
    load = Path("/proc/loadavg").read_text().split()[:3] if Path("/proc/loadavg").exists() else []
    info = {}
    for path, keys in (("/proc/meminfo", ("MemAvailable",)), ("/proc/self/status", ("VmRSS",))):
        if Path(path).exists():
            for ln in Path(path).read_text().splitlines():
                if ln.split(":")[0] in keys:
                    info[ln.split(":")[0]] = ln.split(":")[1].strip()
    return f"load={'/'.join(load)} " + " ".join(f"{k}={v.replace(' ', '')}" for k, v in info.items())


def allocator_state(on_card: bool) -> str:
    """The card's caching allocator: retries, failures, reserved bytes, device calls."""
    if not on_card:
        return ""
    import torch

    stats = torch.cuda.memory_stats()
    keys = ("num_alloc_retries", "num_ooms", "reserved_bytes.all.current", "num_device_alloc",
            "num_device_free")
    return " ".join(f"{k}={stats[k]}" for k in keys if k in stats)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, started: float,
        log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    log(f"[setup] interpreter and imports {time.perf_counter() - started!r} s", file=sys.stderr)
    t0 = time.perf_counter()
    entry = Entry(cell, score_matrix(cell.bench, cell.config), device)
    log(f"[setup] the program's import {time.perf_counter() - t0!r} s", file=sys.stderr)
    try:
        return _run(entry, cell, seed % (1 << 64), seconds, trace, device, started, log)
    finally:
        entry.close()


def _run(entry: Entry, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
         started: float, log) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device == "cuda"
    t, p = cell.traffic, cell.traffic["family"]
    t0 = time.perf_counter()
    # numpy arrays alone, which the garbage collector does not track: a pool of
    # the program's objects would lengthen every full collection of the window
    pool = [families.family(seed, i, p) for i in range(t["pool"])]
    phases = [("pool", time.perf_counter() - t0)]
    warm = 0.0
    for w in range(WARMUP_REQUESTS):
        t0 = time.perf_counter()
        entry(entry.sequences(families.family(seed, t["pool"] + w, p)))
        if on_card:
            torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        phases.append((f"warm-up {w + 1}", warm))
    log("[setup] " + " ".join(f"{k}={v!r}" for k, v in phases) + " s", file=sys.stderr)
    rates = (roofline.card_rates(torch.cuda.get_device_properties(0).multi_processor_count)
             if on_card else None)
    records, failed, attempted = [], 0, 0

    def request(k: int, traced: bool, t_start: float = 0.0) -> None:
        """Family ``k`` of the pool, once; a request ``SLOW`` times the last
        warm-up's wall or more is logged with what the host and card did."""
        nonlocal failed, attempted
        attempted += 1
        seqs = entry.sequences(pool[k])
        with GcClock() as gcc, record_function("request"):
            entry.batch.reset_route_counts()
            use0, cpu0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()
            t0 = time.perf_counter()
            try:
                out = entry(seqs)
            except Exception:  # a failed request is counted and the window goes on
                failed += 1
                log(traceback.format_exc(), file=sys.stderr)
                out = None
            wall = time.perf_counter() - t0
            cpu, use = time.process_time() - cpu0, resource.getrusage(resource.RUSAGE_SELF)
        if wall >= SLOW * warm:
            log(f"[slow] family={k} at_s={t0 - t_start if t_start else 0.0!r} wall_s={wall!r} "
                f"cpu_s={cpu!r} gc_s={gcc.seconds!r} stages={json.dumps(entry.stage_clock)} "
                f"major_faults={use.ru_majflt - use0.ru_majflt} "
                f"switches={use.ru_nvcsw - use0.ru_nvcsw}/{use.ru_nivcsw - use0.ru_nivcsw} "
                f"{host_state()} {allocator_state(on_card)}", file=sys.stderr)
        if out is not None:
            records.append(Record(k, wall, gcc.seconds, entry.chunks(), dict(entry.stage_clock),
                                  dict(entry.port.METRICS.notes), traced, out))

    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    i = 0
    setup_s = time.perf_counter() - started
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        request(i % len(pool), False, t_start)
        i += 1
    window_s = time.perf_counter() - t_start
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    read = None
    if trace:  # requests of their own after the window: the profiler's start-up, its teardown
        # and its parsed events stay out of the window
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
            with record_function("traced"):
                for k in range(int(t["trace_requests"])):
                    request(k % len(pool), True)
        t_read = time.perf_counter()
        read = read_trace(prof)
        del prof
        log(f"[trace] read in {time.perf_counter() - t_read!r} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        log(f"modules of {', '.join(found)} are loaded in the benchmark's process",
            file=sys.stderr)
        raise SystemExit(3)

    for r in records:
        r.work = entry.needed(pool[r.index])
        r.merge = entry.merge_work(pool[r.index], r.output)
    log(window_summary([r for r in records if not r.traced], window_s), file=sys.stderr)
    log(f"[window] {host_state()} {allocator_state(on_card)}", file=sys.stderr)
    result = Run(cell, setup_s, window_s, records, rates, peak_window,
                 load_json(cell.bench / "data" / "kernel_layers.json"), read)
    if read is not None:
        named = [pat for pats in result.layers.values() for pat in pats]
        loose = {k: v for k, v in read.kernel_s.items()
                 if not any(re.search(pat, k) for pat in named)}
        log("[trace] unattributed device seconds: " + (json.dumps(loose) if loose else "none"),
            file=sys.stderr)
        for layer, pats in result.layers.items():
            log(f"[trace] layer {layer}: {read.layer_seconds(pats)!r} s", file=sys.stderr)

    metrics = {}
    for m in cell.readers(per_layer=trace):
        value = reader(cell.bench, m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the program's state freed, the reference on the same inputs
    entry.captured.clear()
    if on_card:
        torch.cuda.empty_cache()
    limits = load_json(cell.bench / "data" / "checks.json")["limits"]
    checks = dict.fromkeys(entry.numbers, 0)
    t_check = time.perf_counter()
    picked = checked_requests([r for r in records if not r.traced] or records, seed,
                              int(t["check_requests"]))
    for r in picked:
        for name, value in ref.judge(pool[r.index], r.output, entry.S, cell.config,
                                     device).items():
            checks[name] += value
    log(f"[check] {len(picked)} requests (families {[r.index for r in picked]}) in "
        f"{time.perf_counter() - t_check!r} s", file=sys.stderr)
    checks["requests_failed"] = failed
    correct = bool(records) and all(v <= limits[k] for k, v in checks.items())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": int(max(setup_peak, peak_window))}
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info}
    if result.trace is not None:
        device_info.update(busy_s=result.trace.busy_s, window_s=result.trace.window_s)
        line["breakdown"] = result.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return line


def read_trace(prof) -> tracing.Trace:
    """The profiler's Chrome trace, written to ``TMPDIR``, read and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracing.read(path, "traced")
    finally:
        os.unlink(path)
