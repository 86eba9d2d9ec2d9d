"""Profiling on ``torch.profiler`` (``praline_tpu_torch/util/metrics.py``):
the CLI's ``--profile-dir`` writes a Chrome trace whose events name the
batch aligner's chunks (``dispatch:...``, the JAX package's span names)
and the pipeline's scopes; the program's spans record under any torch
profiler, one the program did not start included, where ``maybe_trace``
starts no second profiler; with nothing recording the hooks do nothing."""

import json
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from praline_tpu_torch import ALPHABET_AA, METRICS, PralineConfig, builtin_score_matrix
from praline_tpu_torch.cli.main import main
from praline_tpu_torch.io import format_alignment_fasta, load_sequence_fasta
from praline_tpu_torch.kernels import batch
from praline_tpu_torch.msa import msa_align
from praline_tpu_torch.types import Sequence
from praline_tpu_torch.util import metrics

TESTDATA = Path(__file__).resolve().parent.parent / "testdata"


def trace_names(path):
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e.get("name", "") for e in events]


def profiled_names(prof):
    """The names of every event the profiler recorded (read from its raw
    results: ``prof.events()`` builds a Python object an event)."""
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_profile_dir_writes_a_trace_with_dispatch_spans(tmp_path):
    out = tmp_path / "out.aln"
    prof = tmp_path / "prof"
    rc = main([str(TESTDATA / "family10.fasta"), str(out), "--device", "cpu",
               "--profile-dir", str(prof)])
    assert rc == 0
    assert out.read_text() == (TESTDATA / "family10.default.golden.aln").read_text()
    traces = sorted(prof.glob("msa_align.*.pt.trace.json"))
    assert len(traces) == 1
    names = trace_names(traces[0])
    assert "msa_align" in names and "merge" in names
    assert any(n.startswith("dispatch:") for n in names)
    assert {"merge:plan", "merge:assemble", "batch:unpack"} <= set(names)
    assert metrics._trace_dir is None  # disarmed after the run
    assert not torch.autograd.profiler._is_profiler_enabled  # its profiler stopped


def test_unarmed_hooks_do_nothing(tmp_path):
    assert metrics._trace_dir is None
    with metrics.maybe_trace("msa_align"), metrics.span("dispatch:1x1x1"):
        assert not torch.autograd.profiler._is_profiler_enabled
    metrics.enable_profiling(str(tmp_path))
    try:
        with metrics.maybe_trace("outer"):
            assert torch.autograd.profiler._is_profiler_enabled
            with metrics.maybe_trace("inner"), metrics.span("dispatch:2x2x2"):
                torch.ones(3).sum()
    finally:
        metrics.disable_profiling()
    names = trace_names(next(tmp_path.glob("outer.*.pt.trace.json")))
    assert {"outer", "inner", "dispatch:2x2x2"} <= set(names)
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1  # the inner scope wrote none


def test_span_opens_no_range_with_nothing_recording(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with metrics.span("batch:unpack"), metrics.maybe_trace("msa_align"):
        pass


def test_spans_record_under_an_outer_profiler():
    """A profiler the program did not start: ``msa_align`` on family10
    records its pipeline, batch, dispatch and merge spans there, and its
    alignment is the golden's."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aln = msa_align(seqs, builtin_score_matrix("blosum62"), PralineConfig(), device="cpu")
    names = profiled_names(prof)
    assert format_alignment_fasta(aln) == \
        (TESTDATA / "family10.default.golden.fasta").read_text()
    assert {"pipeline:preprofiles", "pipeline:profiles", "pipeline:matrix", "pipeline:tree",
            "batch:group", "batch:stack", "batch:operands", "batch:gather", "batch:unpack",
            "merge:plan", "merge:enqueue", "merge:table", "merge:compose", "merge:collect",
            "merge:assemble", "msa_align", "merge"} <= names
    assert any(n.startswith("dispatch:") for n in names)


def test_maybe_trace_under_an_outer_profiler_writes_no_file(tmp_path):
    metrics.enable_profiling(str(tmp_path))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with metrics.maybe_trace("msa_align"):
                torch.ones(3).sum()
            assert torch.autograd.profiler._is_profiler_enabled  # the outer one still records
    finally:
        metrics.disable_profiling()
    assert list(tmp_path.iterdir()) == []
    assert "msa_align" in profiled_names(prof)


def test_dispatch_span_names():
    assert batch.dispatch_name("two_kernel", 1023, 1023, 64) == "dispatch:1023x1023x64"
    assert batch.dispatch_name("checkpointed", 34431, 34431, 1) == \
        "dispatch:ckpt-tb:34431x34431x1"
    assert batch.dispatch_name("tiled", 4991, 4991, 8) == "dispatch:tiled:4991x4991x8"
    assert batch.dispatch_name("two_kernel", 1023, 511, 256, tracks=True) == \
        "dispatch:tracks:1023x511x256"


def test_long_route_spans_sit_inside_their_dispatch_range(monkeypatch, tmp_path):
    """The lane caps forced down (the whole-row DP to 31 lanes, the fused
    kernel to 63): ``msa_align`` on six members of 40-64 residues runs its
    all-pairs stage on the fused and the tiled route and its merge (rung
    127) on the tiled route; under an outer profiler each ``fused:`` and
    ``tiled:`` span of the wrappers lies inside a ``dispatch:`` range of its
    route, the merge's among them."""
    monkeypatch.setattr(batch.wavefront, "MAX_LANES", 32)
    monkeypatch.setattr(batch, "MAX_LANES_FUSED", 64)
    monkeypatch.delenv(batch.FUSED_DP_ENV, raising=False)
    rng = np.random.default_rng(8)
    seqs = [Sequence(f"s{k}", rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA)
            for k, L in enumerate((64, 40, 45, 50, 54, 59))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        msa_align(seqs, builtin_score_matrix("blosum62"), PralineConfig(), device="cpu")
    assert METRICS.notes["merge_route"] == "tiled"
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def inside(e, prefix):
        a, b = e["ts"], e["ts"] + e["dur"]
        return any(o["name"].startswith(prefix) and o["tid"] == e["tid"] and o["ts"] <= a
                   and b <= o["ts"] + o["dur"] for o in events)

    spans = {kind: [e for e in events if e["name"] == f"{kind}:plain"]
             for kind in ("fused", "tiled")}
    assert spans["fused"] and spans["tiled"]
    assert all(inside(e, f"dispatch:{kind}:") for kind, es in spans.items() for e in es)
    assert any(inside(e, "merge") and inside(e, "dispatch:tiled:127x127x") for e in spans["tiled"])
