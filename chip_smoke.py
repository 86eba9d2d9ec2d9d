#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``praline_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the Hopper kernels (score producer, wavefront DP, traceback walk)
from ``praline_tpu_torch/csrc`` with nvcc, holds each against its plain
PyTorch version on the card (bit for bit) at buckets 1023, 63x127 and
2047, aligns the committed goldens through the CUDA path, then drives the
main path at full size: the all-pairs distance stage on 8192 pairs of
bucket 1023 (five runs) and ``msa_align`` on a seeded 128-sequence family
of lengths 600-1000 (two runs).  One more run of each under
``torch.profiler`` gives the device time per kernel and the busy share.
Every phase raises on failure.  The host layers are reached only through
``praline_tpu_torch``; the run fails if JAX was imported.  The last lines
are a JSON summary of the kernels, the card's name and power limit, and
``{"ok": true, ...}``.  Exits non-zero, printing no result, without a
CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HEADLINE_PAIRS = 8192
HEADLINE_BUCKET = 1023
HEADLINE_RUNS = 5
FAMILY_SIZE = 128
# (B, bucket_x, bucket_y, shortest length) of the kernel = plain checks:
# the headline bucket, a small ragged pair, and bucket 2047, where the DP
# gives each thread two lanes (the merge levels of the msa run take it).
KERNEL_SHAPES = ((64, 1023, 1023, 512), (16, 63, 127, 1), (8, 2047, 2047, 1024))


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


class GcClock:
    """Seconds Python's garbage collector ran while registered (through
    ``gc.callbacks``): tells a collection apart from device or launch time
    in a slow run."""

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


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn`` over ``n`` runs, by CUDA events, after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def count_profiles(rng, n, lo, hi, A):
    """Ragged integer-count profiles (bench.py:69-75): 1-2 members per
    column, so every column inverse is 1/2 or 1/3, never 1."""
    from praline_tpu_torch import ALPHABET_AA, Profile

    out = []
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        c = rng.integers(0, 2, size=(L, A)).astype("float32")
        c[:, 0] += 1.0
        out.append(Profile(c, c[:, 0] * 0, ALPHABET_AA))
    return out


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    if not (ROOT / "praline_tpu_torch" / "csrc").is_dir() or not (ROOT / "testdata").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from praline_tpu_torch.kernels import build

    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True)
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("environment", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc.stdout.strip().splitlines()[-1]),
        triton=triton_version, gpu=repr(smi), devices=torch.cuda.device_count())
    return smi


def phase_build():
    from praline_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    say("build", seconds=round(time.perf_counter() - t0, 3), arch=build.ARCH,
        sources=",".join(p.name for p in build.sources()))


def phase_kernels_vs_plain(dev):
    """Each kernel against its plain version on the same CUDA inputs."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch, profiles_to_stack
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.replay import replay_moves, replay_moves_plain
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores
    from praline_tpu_torch.kernels.wavefront import wavefront_dp

    matrix = builtin_score_matrix("blosum62")
    s = matrix_to_torch(matrix, dev)
    A = matrix.alphabet.size
    rng = np.random.default_rng(SEED)
    timing = {}
    for B, bx, by, lo in KERNEL_SHAPES:
        px = count_profiles(rng, B, lo, bx, A)
        py = count_profiles(rng, B, lo, by, A)
        cx, ivx, lx = profiles_to_stack(px, bx, dev)
        cy, ivy, ly = profiles_to_stack(py, by, dev)
        hs_k = fused_skewed_scores(cx, ivx, cy, ivy, s)
        hs_p = plain_scores(cx, ivx, cy, ivy, s)
        torch.cuda.synchronize()
        if not torch.equal(hs_k, hs_p):
            raise AssertionError(f"producer differs from plain at B={B} {bx}x{by}")
        err_scores = float((hs_k - hs_p).abs().max())
        dp_err = 0.0
        for tb in (False, True):
            got = wavefront_dp(hs_p, lx, ly, (11, 1), "global", tb)
            want = plain_dp(hs_p, lx, ly, (11, 1), "global", tb)
            torch.cuda.synchronize()
            for key in want:
                if not torch.equal(got[key], want[key]):
                    raise AssertionError(f"DP {key} differs (traceback={tb}) at B={B} {bx}x{by}")
            dp_err = max(dp_err, float((got["score"] - want["score"]).abs().max()))
        walk_args = (want["tb"], want["ti"], want["tj"], want["tcode"], (11, 1), "global", bx + by)
        moves_k, n_k = replay_moves(*walk_args)
        moves_p, n_p = replay_moves_plain(*walk_args)
        torch.cuda.synchronize()
        if not (torch.equal(moves_k, moves_p) and torch.equal(n_k, n_p)):
            raise AssertionError(f"traceback walk differs from plain at B={B} {bx}x{by}")
        walk_err = float((moves_k.int() - moves_p.int()).abs().max())
        say("kernel=plain", shape=f"B{B}x{bx}x{by}", producer="bit-equal",
            dp_scores="bit-equal", dp_traceback="bit-equal(all tb bytes)",
            walk="bit-equal(moves, counts)")
        if bx == HEADLINE_BUCKET:
            timing = {
                "scores_ms": cuda_ms(lambda: fused_skewed_scores(cx, ivx, cy, ivy, s), 10),
                "scores_plain_ms": cuda_ms(lambda: plain_scores(cx, ivx, cy, ivy, s), 3),
                "dp_ms": cuda_ms(lambda: wavefront_dp(hs_p, lx, ly, (11, 1), "global"), 10),
                "dp_plain_ms": cuda_ms(lambda: plain_dp(hs_p, lx, ly, (11, 1), "global"), 1),
                "dp_tb_ms": cuda_ms(lambda: wavefront_dp(hs_p, lx, ly, (11, 1), "global", True), 10),
                "walk_ms": cuda_ms(lambda: replay_moves(*walk_args), 10),
                "walk_plain_ms": cuda_ms(lambda: replay_moves_plain(*walk_args), 1),
                "scores_err": err_scores,
                "dp_err": dp_err,
                "walk_err": walk_err,
            }
            say("kernel-times", shape=f"B{B}x{bx}x{by}",
                **{k: round(v, 4) for k, v in timing.items()})
    return timing


GOLDENS = [  # (family, tag, matrix, config kwargs); the first four are the defaults
    ("family10", "default", "blosum62", {}),
    ("family16div", "default", "blosum62", {}),
    ("family64", "default", "blosum62", {}),
    ("dna8", "default", "dna_simple", dict(gap_series=(8, 2), alphabet="dna", score_matrix="dna_simple")),
    ("family10", "ppglobal", "blosum62", dict(preprofile_mode="global")),
    ("family10", "series3_local", "blosum62", dict(gap_series=(13, 7, 1), distance_mode="local", linkage="complete")),
    ("family16div", "pam250_semi_pplocal", "pam250", dict(merge_mode="semiglobal", preprofile_mode="local", gap_series=(10, 2), linkage="single")),
    ("family64", "semi_series3", "blosum62", dict(gap_series=(12, 6, 1), merge_mode="semiglobal", linkage="average")),
]


def phase_goldens(dev):
    from praline_tpu_torch import (
        ALPHABET_AA, ALPHABET_DNA, PralineConfig, builtin_score_matrix,
        format_alignment_clustal, format_alignment_fasta, load_sequence_fasta, msa_align,
    )
    from praline_tpu_torch.kernels import fused_scores, wavefront

    td = ROOT / "testdata"
    before = (fused_scores.launches, wavefront.launches)
    for family, tag, mname, kw in GOLDENS:
        alphabet = ALPHABET_DNA if family == "dna8" else ALPHABET_AA
        seqs = load_sequence_fasta(td / f"{family}.fasta", alphabet)
        t0 = time.perf_counter()
        aln = msa_align(seqs, builtin_score_matrix(mname), PralineConfig(**kw), device=dev)
        if format_alignment_fasta(aln) != (td / f"{family}.{tag}.golden.fasta").read_text():
            raise AssertionError(f"{family}.{tag}: FASTA differs from the golden")
        if format_alignment_clustal(aln) != (td / f"{family}.{tag}.golden.aln").read_text():
            raise AssertionError(f"{family}.{tag}: CLUSTAL differs from the golden")
        say("golden", case=f"{family}.{tag}", result="byte-equal",
            seconds=round(time.perf_counter() - t0, 3))
    if not (fused_scores.launches > before[0] and wavefront.launches > before[1]):
        raise AssertionError("goldens did not launch both kernels")


def headline_pairs():
    """bench.py:63-97: 256 ragged count profiles (512-1023), 8192 pairs."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix

    matrix = builtin_score_matrix("blosum62")
    rng = np.random.default_rng(SEED)
    profs = count_profiles(rng, 256, HEADLINE_BUCKET // 2, HEADLINE_BUCKET, matrix.alphabet.size)
    pairs = [(profs[(i * 7) % 256], profs[(i * 13 + 5) % 256]) for i in range(HEADLINE_PAIRS)]
    cells = float(sum(float(p.length) * q.length for p, q in pairs))
    return matrix, pairs, cells


def phase_all_pairs(dev, matrix, pairs, cells):
    """The distance stage's dispatch at the headline workload."""
    import numpy as np
    import torch

    from praline_tpu_torch.convert import matrix_to_torch, profiles_to_stack
    from praline_tpu_torch.kernels.batch import ProfileArena, align_pairs_batched
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores

    arena = ProfileArena(matrix.alphabet.size, (HEADLINE_BUCKET,), dev)

    def run():
        out = align_pairs_batched(
            pairs, matrix, (11, 1), "global", device=dev, traceback=False,
            bucket_sizes=(HEADLINE_BUCKET,), batch_pairs=HEADLINE_PAIRS, arena=arena,
        )
        torch.cuda.synchronize()
        return out

    walls, gcs, res = [], [], None
    for _ in range(HEADLINE_RUNS):
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            out = run()
            walls.append(time.perf_counter() - t0)
        gcs.append(gc_clock.seconds)
        if res is not None and out != res:
            raise AssertionError("all-pairs: two runs differ")
        res = out
    wall = statistics.median(walls[1:])
    # 64 sampled problems against the plain versions on the card
    sample = np.random.default_rng(SEED + 1).choice(len(pairs), 64, replace=False)
    cx, ivx, lx = profiles_to_stack([pairs[i][0] for i in sample], HEADLINE_BUCKET, dev)
    cy, ivy, ly = profiles_to_stack([pairs[i][1] for i in sample], HEADLINE_BUCKET, dev)
    want = plain_dp(plain_scores(cx, ivx, cy, ivy, matrix_to_torch(matrix, dev)), lx, ly)
    for k, i in enumerate(sample):
        r = res[i]
        got = (r.score, r.length, r.ti, r.tj)
        exp = tuple(want[key][k].item() for key in ("score", "length", "ti", "tj"))
        if got != exp:
            raise AssertionError(f"all-pairs problem {i}: {got} != plain {exp}")
    if not all(np.isfinite(r.score) and r.length > 0 for r in res):
        raise AssertionError("all-pairs: non-finite score or empty path")
    say("all-pairs", pairs=len(pairs), bucket=HEADLINE_BUCKET, gap_series="11,1",
        mode="global", cells=int(cells), walls_s=",".join(f"{w:.4f}" for w in walls),
        gc_s=",".join(f"{g:.4f}" for g in gcs),
        warm_median_s=round(wall, 4), dp_cells_per_s=f"{cells / wall:.4e}",
        sampled_vs_plain="64/64 bit-equal")
    return run


def synthetic_family(n=FAMILY_SIZE, seed=SEED):
    """A root of 1000 residues; each member takes 25% substitutions, two
    short insertions and deletions down to a length drawn from 600-1000."""
    import numpy as np

    from praline_tpu_torch import ALPHABET_AA, Sequence

    rng = np.random.default_rng(seed)
    root = rng.integers(0, 20, size=1000)
    seqs = []
    for k in range(n):
        toks = root.copy()
        sub = rng.random(toks.size) < 0.25
        toks[sub] = rng.integers(0, 20, size=int(sub.sum()))
        for _ in range(2):
            at = int(rng.integers(0, toks.size + 1))
            toks = np.insert(toks, at, rng.integers(0, 20, size=int(rng.integers(1, 4))))
        target = int(rng.integers(600, 1001))
        while toks.size > target:
            cut = min(toks.size - target, int(rng.integers(1, 40)))
            at = int(rng.integers(0, toks.size - cut + 1))
            toks = np.delete(toks, np.arange(at, at + cut))
        seqs.append(Sequence(f"s{k:03d}", toks.astype(np.int32), ALPHABET_AA))
    return seqs


def phase_msa(dev):
    """``msa_align`` end to end on the synthetic family, twice; returns a
    third run for the profiler."""
    import numpy as np

    from praline_tpu_torch import (
        GAP, METRICS, PralineConfig, builtin_score_matrix, format_alignment_fasta, msa_align,
    )

    seqs = synthetic_family()
    matrix = builtin_score_matrix("blosum62")
    texts = []
    for run in (1, 2):
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            aln = msa_align(seqs, matrix, PralineConfig(), device=dev)
            wall = time.perf_counter() - t0
        stages = METRICS.summary()
        rows = np.asarray(aln.rows)
        if rows.shape != (len(seqs), aln.num_columns):
            raise AssertionError("msa: rows of unequal width")
        for seq, row in zip(seqs, rows):
            if not np.array_equal(row[row != GAP], seq.tokens):
                raise AssertionError(f"msa: row {seq.name} does not degap to its input")
        texts.append(format_alignment_fasta(aln))
        say("msa", run=run, sequences=len(seqs), columns=aln.num_columns,
            wall_s=round(wall, 4), gc_s=round(gc_clock.seconds, 4),
            **{f"{k}_s": v["seconds"] for k, v in stages.items()})
    if texts[0] != texts[1]:
        raise AssertionError("msa: two runs gave different bytes")
    return lambda: msa_align(seqs, matrix, PralineConfig(), device=dev)


def short_kernel_name(key: str) -> str:
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0].strip()[:60] if not key.startswith("Memcpy") else key


def phase_profile(name, fn):
    """One more run of ``fn`` under ``torch.profiler``: device time per
    kernel and the busy share, summed device time over the profiled wall
    (the profiler's own host overhead is inside that wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        say("profile", run=name, wall_s=round(wall, 4), device_time="not measured (no device events)")
        return
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    say("profile", run=name, wall_s=round(wall, 4), device_s=round(device_s, 4),
        busy_share=round(device_s / wall, 4), top=json.dumps(
            [[short_kernel_name(e.key), e.count, round(e.self_device_time_total / 1e3, 3)]
             for e in top]))


def main() -> int:
    smi = phase_environment()
    import torch

    from praline_tpu_torch.device import resolve_device
    from praline_tpu_torch.kernels import fused_scores, replay, wavefront

    dev = resolve_device("cuda")
    phase_build()
    timing = phase_kernels_vs_plain(dev)
    phase_goldens(dev)
    matrix, pairs, cells = headline_pairs()

    # ---- the main path: launches are counted from here on ----
    for counted in (fused_scores, wavefront, replay):
        counted.reset_launches()
    all_pairs_run = phase_all_pairs(dev, matrix, pairs, cells)
    msa_run = phase_msa(dev)
    launches = {"scores": fused_scores.launches, "dp": wavefront.launches,
                "walk": replay.launches}
    # ---- end of the main path ----
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    phase_profile("all-pairs", all_pairs_run)
    phase_profile("msa", msa_run)
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported: the port must run without it")

    kernels = [
        {"name": "skewed_scores", "route": "cuda",
         "source": "praline_tpu_torch/csrc/scores.cu",
         "replaces": "praline_tpu/kernels/fused_scores.py:359 (fused_skewed_scores_strip), "
                     "praline_tpu/kernels/fused_scores.py:119 (fused_skewed_scores)",
         "launches": launches["scores"], "max_abs_err": timing["scores_err"],
         "ms": timing["scores_ms"], "plain_ms": timing["scores_plain_ms"]},
        {"name": "wavefront_dp", "route": "cuda",
         "source": "praline_tpu_torch/csrc/wavefront_dp.cu",
         "replaces": "praline_tpu/kernels/strip.py:587 (wavefront_dp_strip), "
                     "praline_tpu/kernels/pallas_dp.py:628 (wavefront_dp_pallas)",
         "launches": launches["dp"], "max_abs_err": timing["dp_err"],
         "ms": timing["dp_ms"], "plain_ms": timing["dp_plain_ms"]},
        {"name": "replay_moves", "route": "cuda",
         "source": "praline_tpu_torch/csrc/replay.cu",
         "replaces": "praline_tpu/kernels/replay.py:131 (replay_moves, an XLA scan)",
         "launches": launches["walk"], "max_abs_err": timing["walk_err"],
         "ms": timing["walk_ms"], "plain_ms": timing["walk_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
