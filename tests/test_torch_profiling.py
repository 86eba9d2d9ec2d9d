"""Profiling on ``torch.profiler`` (``praline_tpu_torch/util/metrics.py``):
the CLI's ``--profile-dir`` writes a Chrome trace whose events name the
batch aligner's chunks (``dispatch:...``, the JAX package's span names)
and the pipeline's scopes; with nothing armed the hooks do nothing."""

import json
from pathlib import Path

import torch

from praline_tpu_torch.cli.main import main
from praline_tpu_torch.kernels import batch
from praline_tpu_torch.util import metrics

TESTDATA = Path(__file__).resolve().parent.parent / "testdata"


def trace_names(path):
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e.get("name", "") for e in events]


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
    assert metrics._trace_dir is None and not metrics._trace_active  # disarmed after the run


def test_unarmed_hooks_do_nothing(tmp_path):
    assert metrics._trace_dir is None
    with metrics.maybe_trace("msa_align"), metrics.annotate("dispatch:1x1x1"):
        assert not metrics._trace_active
    metrics.enable_profiling(str(tmp_path))
    try:
        with metrics.maybe_trace("outer"):
            assert metrics._trace_active
            with metrics.maybe_trace("inner"), metrics.annotate("dispatch:2x2x2"):
                torch.ones(3).sum()
    finally:
        metrics.disable_profiling()
    names = trace_names(next(tmp_path.glob("outer.*.pt.trace.json")))
    assert {"outer", "inner", "dispatch:2x2x2"} <= set(names)


def test_dispatch_span_names():
    assert batch.dispatch_name("two_kernel", 1023, 1023, 64) == "dispatch:1023x1023x64"
    assert batch.dispatch_name("checkpointed", 34431, 34431, 1) == \
        "dispatch:ckpt-tb:34431x34431x1"
    assert batch.dispatch_name("tiled", 4991, 4991, 8) == "dispatch:tiled:4991x4991x8"
    assert batch.dispatch_name("two_kernel", 1023, 511, 256, tracks=True) == \
        "dispatch:tracks:1023x511x256"
