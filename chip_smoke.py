#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``praline_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the seven Hopper kernel sources (the score producer's two tiers,
tensor-core and scalar, wavefront DP, fused producer + DP on a
thread-block cluster a problem, lane-tiled DP, traceback walk, and the
benchmark's probes) from ``praline_tpu_torch/csrc`` with nvcc, one process
per source, with ``-Xptxas -v`` (registers and spills of the producers,
the DPs and the probes are printed, and the fused kernel's cluster
occupancy at every cluster size), and holds each kernel against its plain
PyTorch version on the card, bit for bit: both producer tiers at buckets
1023, 63x127 and 2047 and at the tensor-core predicate's edges (alphabets
4, 32 and 23, counts of 255, |T| = 32766, |H| just under 2**24, one-hot
profiles; each output NaN-poisoned first), the other kernels at buckets
1023, 63x127 and 2047, the DPs over every mode and three gap series at
63x127, the fused kernel on both score tiers (NaN-poisoned outputs) at
those shapes, past the two-kernel lane cap (3000x3000), at a long y
(600x4000), at every cluster size (1 to 8 CTAs) and with lx leaving the
high ranks idle, the tiled kernel against its plain version at 4 x
700x600 (every mode, three series, both score sources, scores and
traceback, two tile widths and two visit depths) and, on one 4600x4400
traceback problem, against the plain DP; the probes at the benchmark's
shapes (K7 f32[256, 1024] through 131072 links, into the subnormal range;
K8 f32[1056, 256], four chains of 131072 links; K9 at every
TPU write block on a small tensor and on f32[64, 17408, 1024], on an
unaligned strided view with -0.0, and at the producer's block).  It times
the fused kernel on both tiers beside the two-kernel route, the tiled
kernel over the producer's hs and the plain version at the headline
bucket, a merge level and the long family's bucket, the tiled kernel
beside the fused kernel at 3000x3000 and beside the whole-row DP at
buckets 1023 and 2047, K9 beside ``torch.full``, aligns the committed
goldens through the CUDA path on both routes, then drives the main paths
at full size, with the launch counts set to 0 before each and read after
its own runs: the all-pairs distance stage on 8192 pairs of bucket 1023
(five runs on the default two-kernel route), ``msa_align`` on a seeded
128-sequence family of lengths 600-1000 (two runs), on a seeded
32-sequence family of lengths 1800-2400 (two runs), which needs the fused
kernel, and on 8 members of lengths 4300-5000 (two runs; the size of a
dynein heavy chain), which needs the tiled kernel; the two-track
composite workload of ``bench.py``'s ``tracks`` config (1024 pairs of
one-hot profiles of 512-1023 residues, BLOSUM62 + PAM250 weighted 1 and
0.5; two runs scores only, then one with traceback, each its own path);
and the port's ``utilization`` and ``wprobe`` bench configs, whose rates
are printed.  After them, sampled problems of each all-pairs stage and 16
composite problems are held against the plain versions, and the headline
runs four more times forced onto the fused route, counted on their own,
to the same results.  One more run of each main path under
``torch.profiler`` gives the device time per kernel and the busy share.
Every producer and fused launch of every main path must take the
tensor-core tier (the launches are counted per tier).  Every phase raises
on failure.  The host layers are reached only through
``praline_tpu_torch``; the run fails if JAX or the JAX package was
imported.  The last lines are a JSON summary of the kernels (with each
one's bound: the larger of the bytes its function must move over 3.35
TB/s and its operations over the H100 SXM's published rates, 67 TFLOP/s
for f32 and 1979 TOP/s for int8 on the tensor cores), the card's name and
power limit, and ``{"ok": true, ...}``.
Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
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
FUSED_ROUTE_RUNS = 4
FAMILY_SIZE = 128
LONG_FAMILY_SIZE = 32
LONG8_SIZE = 8
# (B, bucket_x, bucket_y, shortest length) of the kernel = plain checks:
# the headline bucket, a small ragged pair, and bucket 2047, where the DP
# gives each thread two lanes (the merge levels of the msa run take it).
KERNEL_SHAPES = ((64, 1023, 1023, 512), (16, 63, 127, 1), (8, 2047, 2047, 1024))
MODES = ("global", "semiglobal", "local")
SWEEP_SERIES = ((11, 1), (13, 7, 1), (5,))
# (B, Lx, Ly, shortest length, mode) of the fused kernel's long checks, all
# with traceback: rows past the two-kernel DP's 2048 lanes, and a long y.
# The plain DP walks their 6000 and 4600 diagonals one at a time, so they
# are kept to two; global past 2048 lanes is held by the long family's
# sampled problems.
FUSED_LONG_SHAPES = ((2, 3000, 3000, 2500, "local"), (2, 600, 4000, 500, "semiglobal"))
# The tiled kernel against its plain version: (B, Lx, Ly, shortest length),
# and the (tile lanes, diagonals a visit) it runs at.  1299 steps: 3 divides
# them, 32 does not.
TILED_SHAPE = (4, 700, 600, 1)
TILED_CONFIGS = ((128, 3), (256, 32))
# One long traceback problem against the plain DP (rows past 4096 lanes).
TILED_LONG = (1, 4600, 4400, 4000, "local")
# (B, lanes - 1 = Lx = Ly, shortest length) where both the fused and the
# tiled kernel take the rows: their times side by side.
TILED_TIMES_SHAPE = (2, 3000, 2500)
# (B, lanes - 1, shortest length) where the whole-row DP takes the rows at
# one and at two lanes a thread: the tiled kernel's times beside it.
TILED_VS_DP_SHAPES = ((64, 1023, 512), (64, 2047, 1024))
# The H100 SXM's published rates (NVIDIA's H100 datasheet): device memory,
# f32 outside the tensor cores and dense int8 on the tensor cores.  The DP's
# f32 operations a cell at k = 2: two subtracts, a compare and a length add
# per gap side, an add and a length add for M, two compares for the best
# state (selects not counted).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
DP_OPS_PER_CELL = 12


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


def cuda_ms(fn, n: int, warm_up: bool = True) -> float:
    """Mean milliseconds of ``fn`` over ``n`` runs, by CUDA events, after
    one warm-up run unless ``warm_up`` is False (the plain versions, which
    take seconds and were run at the same shape by an earlier check)."""
    import torch

    from praline_tpu_torch.bench import device_ms

    return device_ms(fn, n, torch.device("cuda"), warm_up)


@contextlib.contextmanager
def route_knob(value: str):
    """``PRALINE_FUSED_DP`` set to ``value`` inside the block, unset after
    it (``main`` runs everything else on the default routes)."""
    os.environ["PRALINE_FUSED_DP"] = value
    try:
        yield
    finally:
        del os.environ["PRALINE_FUSED_DP"]


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


def ptxas_usage(log: str) -> dict[str, tuple[int, int, int]]:
    """Kernel (mangled name) -> (registers, spill store bytes, spill load
    bytes) from ``-Xptxas -v`` output."""
    usage, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)), *spill)
            name = None
    return usage


def phase_build():
    """All sources compiled anew with ``-Xptxas -v``, in parallel; the
    tiled kernel's registers and spills at 1, 2, 3 and 15 gap levels."""
    from praline_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load_library()
    say("build", seconds=round(time.perf_counter() - t0, 3), arch=build.ARCH,
        sources=",".join(p.name for p in build.sources()),
        per_source_s=",".join(f"{k}:{v:.3f}" for k, v in sorted(build.last_build_seconds.items())))
    usage = ptxas_usage("\n".join(build.last_build_log.values()))
    kernels = (("tiled_hs_kernel", "Li1E"), ("tiled_rows_kernel", "Li1E"),
               ("wavefront_kernel", "Li1E"), ("fused_cluster_kernel", "Lb1E"),
               ("fused_cluster_kernel", "Lb0E"))
    for kernel, second in kernels:
        found = {}
        for k in (1, 2, 3, 15):
            key = next((n for n in usage if f"{kernel}ILi{k}E{second}" in n), None)
            if key is None:
                raise AssertionError(f"build: no -Xptxas -v line for {kernel}<{k}, {second}>")
            found[f"K{k}"] = "{}regs/{}B-spill-stores/{}B-spill-loads".format(*usage[key])
        tier = {"Lb1E": "mma", "Lb0E": "scalar"}.get(second)
        say("registers", kernel=kernel, **({"tier": tier} if tier else {}), lanes_per_thread=1,
            **found)
    phase_cluster_occupancy()
    probes = {}
    for kernel in ("alu_chains_kernel", "smem_chain_kernel", "write_blocks_kernel"):
        key = next((n for n in usage if kernel in n), None)
        if key is None:
            raise AssertionError(f"build: no -Xptxas -v line for {kernel}")
        probes[kernel.split("_kernel")[0]] = "{}regs/{}B-spill-stores/{}B-spill-loads".format(
            *usage[key])
    say("registers", kernel="probes", **probes)
    producers = {}
    for kernel in ("skewed_scores_mma_kernel", "skewed_scores_kernel"):
        key = next((n for n in usage if kernel in n), None)
        if key is None:
            raise AssertionError(f"build: no -Xptxas -v line for {kernel}")
        producers[kernel] = "{}regs/{}B-spill-stores/{}B-spill-loads".format(*usage[key])
    smem = re.search(r"Compiling entry function '[^']*skewed_scores_mma_kernel[^']*'.*?"
                     r"Used \d+ registers[^\n]*", build.last_build_log.get("scores_mma.cu", ""),
                     re.S)
    say("registers", kernel="producers", **producers,
        mma_ptxas=repr(smem.group(0).splitlines()[-1].strip()) if smem else "not found")


def phase_cluster_occupancy():
    """The fused kernel's clusters: for R = 1 .. 8 CTAs (at Lp = 512 R) at
    k = 2 and 15 on each tier, the shared memory a CTA (the kernel's layout
    and ``fused_geometry``'s, which must agree) and how many clusters the
    card holds at once (``cudaOccupancyMaxActiveClusters``, which must be
    at least 1)."""
    from praline_tpu_torch.kernels import build, fused_dp

    lib = build.load_library()
    for k in (2, 15):
        for tier in fused_dp.TIERS:
            rows = []
            for R in range(1, fused_dp.MAX_CLUSTER + 1):
                g = fused_dp.fused_geometry(fused_dp.CTA_LANES * R, k)
                smem = g.smem_bytes if tier == "mma" else g.smem_scalar_bytes
                kernel_smem = lib.praline_fused_dp_smem(g.W, g.T, k, fused_dp.TIERS.index(tier))
                if kernel_smem != smem:
                    raise AssertionError(f"fused smem W={g.W} T={g.T} k={k} {tier}: kernel "
                                         f"{kernel_smem} B, fused_geometry {smem} B")
                clusters = fused_dp.max_active_clusters(k, tier, g)
                if clusters < 1:
                    raise AssertionError(f"no cluster of {R} CTAs fits at k={k} on {tier}")
                rows.append(f"R{R}:W{g.W}:{smem}B:{clusters}")
            say("clusters", kernel="fused_cluster_kernel", k=k, tier=tier, T=fused_dp.BOX_STEPS,
                R_W_smem_active_clusters=",".join(rows))


def same_outputs(got, want, what) -> float:
    """Raise unless every output tensor is equal; the largest score error."""
    import torch

    torch.cuda.synchronize()
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} != {sorted(want)}")
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"{what}: {key} differs from plain")
    return float((got["score"] - want["score"]).abs().max())


def bound(nbytes: float, ops: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over
    its memory rate and the operations' time, ``ops`` f32 operations over
    the f32 rate plus ``int8_ops`` tensor-core operations over the int8
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_OPS_PER_S + int8_ops / INT8_OPS_PER_S) * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def needed_cells(lx, ly) -> float:
    """DP cells these problems need: the sum of lx * ly.  Bucket and skew
    padding and cells past the true lengths never reach a terminal, so no
    bound counts them."""
    return float((lx.double() * ly.double()).sum())


def operand_bytes(lx, ly, A) -> float:
    """The profile columns these problems hold, read once (A counts and an
    inverse a column), and the score matrix."""
    return float(lx.double().sum() + ly.double().sum()) * (A + 1) * 4 + A * A * 4


def output_bytes(lx, ly, out) -> float:
    """A DP's outputs written once: the per-problem results, and one
    traceback byte for each needed cell."""
    rest = nbytes(*(v for k, v in out.items() if k != "tb"))
    return rest + (needed_cells(lx, ly) if "tb" in out else 0.0)


def producer_ops(lx, ly, A, tier) -> tuple[float, float]:
    """(f32, tensor-core int8) operations of the scores on ``tier``: T = Cx
    @ S over the true rows of x, then a needed cell's dot product of A terms
    and two scales.  On "mma" the dot product runs on the int8 tensor cores
    and a cell's f32-rate work is the two scales and the recombination of
    its two limbs (a multiply and an add)."""
    t_ops, cells = float(lx.double().sum()) * A * A * 2, needed_cells(lx, ly)
    if tier == "mma":
        return t_ops + cells * 4, cells * 2 * A
    return t_ops + cells * (2 * A + 2), 0.0


def dp_bound(lx, ly, out) -> dict:
    """A DP over hs: the hs cells it needs read once, its outputs written
    once, DP_OPS_PER_CELL f32 operations a cell."""
    n = needed_cells(lx, ly)
    return bound(n * 4 + output_bytes(lx, ly, out), n * DP_OPS_PER_CELL)


def fused_bound(ops, out, tier) -> dict:
    """A DP that computes each score in place on ``tier``: its operands read
    once, its outputs written once, the producer's and the DP's
    operations."""
    A, lx, ly = ops[0].shape[2], ops[5], ops[6]
    f32_ops, int8_ops = producer_ops(lx, ly, A, tier)
    return bound(operand_bytes(lx, ly, A) + output_bytes(lx, ly, out),
                 f32_ops + needed_cells(lx, ly) * DP_OPS_PER_CELL, int8_ops)


def stacked_operands(rng, dev, s, B, bx, by, lo):
    """Count-profile stacks of B pairs (lengths lo..bucket) on the card."""
    from praline_tpu_torch.bench import count_profiles
    from praline_tpu_torch.convert import profiles_to_stack

    A = s.shape[0]
    cx, ivx, lx = profiles_to_stack(count_profiles(rng, B, min(lo, bx), bx, A), bx, dev)
    cy, ivy, ly = profiles_to_stack(count_profiles(rng, B, min(lo, by), by, A), by, dev)
    return cx, ivx, cy, ivy, s, lx, ly


def phase_kernels_vs_plain(dev):
    """Each kernel against its plain version on the same CUDA inputs: the
    producer, the DP and the walk at KERNEL_SHAPES, the fused kernel beside
    them; then both DPs over every mode and SWEEP_SERIES at 63x127."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.replay import replay_moves, replay_moves_plain
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores
    from praline_tpu_torch.kernels.wavefront import wavefront_dp

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    rng = np.random.default_rng(SEED)
    timing = {"fused_err": 0.0}
    for B, bx, by, lo in KERNEL_SHAPES:
        ops = stacked_operands(rng, dev, s, B, bx, by, lo)
        cx, ivx, cy, ivy, _, lx, ly = ops
        if producer_tier(ops) != "mma":
            raise AssertionError(f"the tensor-core predicate refused B={B} {bx}x{by}")
        hs_p = plain_scores(cx, ivx, cy, ivy, s)
        err_scores = max(producer_vs_plain(ops[:5], hs_p, tier, f"B={B} {bx}x{by}")
                         for tier in ("mma", "scalar"))
        dp_err = 0.0
        for tb in (False, True):
            want = plain_dp(hs_p, lx, ly, (11, 1), "global", tb)
            dp_err = max(dp_err, same_outputs(wavefront_dp(hs_p, lx, ly, (11, 1), "global", tb),
                                              want, f"DP traceback={tb} B={B} {bx}x{by}"))
            timing["fused_err"] = max(timing["fused_err"], fused_vs_plain(
                ops, (11, 1), "global", want, f"traceback={tb} B={B} {bx}x{by}"))
        walk_args = (want["tb"], want["ti"], want["tj"], want["tcode"], (11, 1), "global", bx + by)
        moves_k, n_k = replay_moves(*walk_args)
        moves_p, n_p = replay_moves_plain(*walk_args)
        torch.cuda.synchronize()
        if not (torch.equal(moves_k, moves_p) and torch.equal(n_k, n_p)):
            raise AssertionError(f"traceback walk differs from plain at B={B} {bx}x{by}")
        walk_err = float((moves_k.int() - moves_p.int()).abs().max())
        say("kernel=plain", shape=f"B{B}x{bx}x{by}", producer="bit-equal(mma, scalar; NaN-poisoned)",
            dp_scores="bit-equal", dp_traceback="bit-equal(all tb bytes)",
            fused_scores_and_traceback="bit-equal(mma, scalar; NaN-poisoned)",
            walk="bit-equal(moves, counts)")
        if bx == HEADLINE_BUCKET:
            A = s.shape[0]
            # the walk reads one traceback byte a move and writes the move
            moves_bytes = 2 * float(n_k.sum()) + nbytes(n_k)
            timing.update({
                "scores_bound": bound(operand_bytes(lx, ly, A) + needed_cells(lx, ly) * 4,
                                      *producer_ops(lx, ly, A, "mma")),
                "dp_bound": dp_bound(lx, ly, plain_dp(hs_p, lx, ly, (11, 1), "global")),
                "walk_bound": bound(moves_bytes, 0.0),
                # the library yardstick of the producer: H = (Cx @ S) @ Cy^T, unskewed
                "scores_library_ms": cuda_ms(
                    lambda: torch.bmm(torch.matmul(cx, s), cy.transpose(1, 2)), 10),
                # the two tiers in turns: mma, scalar, mma again
                "scores_ms": cuda_ms(lambda: fused_skewed_scores(cx, ivx, cy, ivy, s, tier="mma"), 10),
                "scores_scalar_ms": cuda_ms(
                    lambda: fused_skewed_scores(cx, ivx, cy, ivy, s, tier="scalar"), 10),
                "scores_again_ms": cuda_ms(
                    lambda: fused_skewed_scores(cx, ivx, cy, ivy, s, tier="mma"), 10),
                # the store pattern alone (K9 at csrc/scores.cu's blocks) on the same hs shape
                "scores_hs_pattern_ms": hs_pattern_ms(hs_p),
                "scores_hs_pattern_512_ms": hs_pattern_ms(hs_p, 512),
                "scores_plain_ms": cuda_ms(lambda: plain_scores(cx, ivx, cy, ivy, s), 3),
                "dp_ms": cuda_ms(lambda: wavefront_dp(hs_p, lx, ly, (11, 1), "global"), 10),
                "dp_plain_ms": cuda_ms(lambda: plain_dp(hs_p, lx, ly, (11, 1), "global"), 1,
                                       warm_up=False),
                "dp_tb_ms": cuda_ms(lambda: wavefront_dp(hs_p, lx, ly, (11, 1), "global", True), 10),
                "walk_ms": cuda_ms(lambda: replay_moves(*walk_args), 10),
                "walk_plain_ms": cuda_ms(lambda: replay_moves_plain(*walk_args), 1, warm_up=False),
                "scores_err": err_scores,
                "dp_err": dp_err,
                "walk_err": walk_err,
            })
            say("kernel-times", shape=f"B{B}x{bx}x{by}",
                **{k: (round(v, 4) if isinstance(v, float) else json.dumps(v))
                   for k, v in timing.items()})

    timing["scores_edge_err"] = phase_producer_edges(dev)
    t0 = time.perf_counter()
    B, bx, by = 16, 63, 127
    for mode in MODES:
        for series in SWEEP_SERIES:
            ops = stacked_operands(rng, dev, s, B, bx, by, 1)
            hs_p = plain_scores(*ops[:5])
            for tb in (False, True):
                want = plain_dp(hs_p, ops[5], ops[6], series, mode, tb)
                what = f"{mode} {series} traceback={tb} B{B}x{bx}x{by}"
                same_outputs(wavefront_dp(hs_p, ops[5], ops[6], series, mode, tb), want, "DP " + what)
                timing["fused_err"] = max(timing["fused_err"],
                                          fused_vs_plain(ops, series, mode, want, what))
    say("kernel=plain-modes", shape=f"B{B}x{bx}x{by}", modes=",".join(MODES),
        series="|".join(",".join(map(str, g)) for g in SWEEP_SERIES), traceback="both",
        dp="bit-equal", fused="bit-equal(mma, scalar; NaN-poisoned)",
        seconds=round(time.perf_counter() - t0, 3))
    return timing


def producer_tier(ops) -> str:
    """The producer tier the batch drivers' predicate gives these operands
    (their statistics taken from host copies)."""
    from praline_tpu_torch.kernels.fused_scores import tier_of

    cx, _, cy, _, s = ops[:5]
    return tier_of(cx.cpu().numpy(), cy.cpu().numpy(), s.cpu().numpy())


def producer_vs_plain(ops, want, tier, what) -> float:
    """The producer's ``tier`` kernel into a NaN-poisoned tensor, held bit
    for bit against the plain version's ``want``; the largest difference
    (0.0)."""
    import torch

    from praline_tpu_torch.kernels import fused_scores

    out = torch.full(want.shape, float("nan"), device=want.device)
    before = dict(fused_scores.launches)
    fused_scores.fused_skewed_scores(*ops, tier=tier, out=out)
    if fused_scores.launches[tier] != before[tier] + 1:
        raise AssertionError(f"producer {tier}: no launch counted")
    return bit_equal(out, want, f"producer {tier} at {what}")


def hs_pattern_ms(hs, diagonals=128) -> float:
    """The producers' store pattern alone (K9 ``write_blocks`` at blocks of
    128 lanes x ``diagonals`` diagonals of a problem: 128 is the blocks of
    ``csrc/scores.cu`` and of ``csrc/scores_mma.cu``) over a tensor of
    ``hs``'s shape."""
    import torch

    from praline_tpu_torch.kernels import probes

    out = torch.empty_like(hs)
    xv = torch.tensor([[1.5]], device=hs.device)
    block = (1, diagonals, probes.HS_BLOCK[2])
    return cuda_ms(lambda: probes.write_blocks(xv, block=block,
                                               out=probes.hs_pattern_view(out)), 10)


def edge_operands(rng, B, Lx, Ly, A):
    """Operands at the tensor-core predicate's edges: S of entries in
    [-127, 127] with +127 twice and -127 once in row 0; x columns of 258
    counts (one of them 258 copies of residue 0: |T| = 32766, just under
    2**15); y columns of two residues of 255 counts (one meets both +127
    entries: |H_int| = 32766 * 510, just under 2**24); zero counts and
    inverse 1.0 past random lengths."""
    import numpy as np

    s = rng.integers(-127, 128, size=(A, A)).astype(np.float32)
    s[0, 1] = s[0, 2] = 127
    s[0, 3] = -127
    cx = rng.multinomial(258, np.ones(A) / A, size=(B, Lx)).astype(np.float32)
    cy = np.zeros((B, Ly, A), np.float32)
    k = np.argsort(rng.random((B, Ly, A)), axis=-1)[..., :2]
    np.put_along_axis(cy, k, 255.0, axis=-1)
    cx[:, 0] = 0
    cx[:, 0, 0] = 258
    cy[:, 0] = 0
    cy[:, 0, 1] = cy[:, 0, 2] = 255
    lx = rng.integers(1, Lx + 1, size=B)
    ly = rng.integers(1, Ly + 1, size=B)
    for b in range(B):
        cx[b, max(1, lx[b]):] = 0
        cy[b, max(1, ly[b]):] = 0
    inv = lambda c: (np.float32(1) / np.maximum(c.sum(-1, dtype=np.float32), 1)).astype(np.float32)
    return cx, inv(cx), cy, inv(cy), s


# (B, Lx, Ly, A) of the producer's edge cases: the alphabets 4, 32 and 23,
# Lx != Ly, B = 1, a single column on either side, ragged last blocks.
PRODUCER_EDGES = ((3, 300, 200, 4), (1, 130, 70, 32), (2, 64, 1, 23), (2, 1, 257, 23),
                  (5, 1023, 511, 20))


def phase_producer_edges(dev) -> float:
    """Both producer tiers bit for bit against the plain version at the
    tensor-core predicate's edges (PRODUCER_EDGES, every case admitted,
    each output NaN-poisoned), and on one-hot profiles under BLOSUM62 and
    PAM250 (every |T| <= 127: the kernel's one-pass blocks)."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import operands_from_numpy
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores

    rng = np.random.default_rng(SEED + 13)
    t0, err, cases = time.perf_counter(), 0.0, []
    for B, Lx, Ly, A in PRODUCER_EDGES:
        cases.append((f"edge B{B}x{Lx}x{Ly} A{A}", edge_operands(rng, B, Lx, Ly, A)))
    for name in ("blosum62", "pam250"):
        s = builtin_score_matrix(name).as_f32()
        A = s.shape[0]
        side = [np.eye(A, dtype=np.float32)[rng.integers(0, 20, size=(16, L))] for L in (700, 900)]
        ones = [np.ones(c.shape[:2], np.float32) for c in side]
        cases.append((f"one-hot {name} B16x700x900", (side[0], ones[0], side[1], ones[1], s)))
    for what, arrs in cases:
        ops = operands_from_numpy(*arrs, [1], [1], dev)[:5]
        if producer_tier(ops) != "mma":
            raise AssertionError(f"the tensor-core predicate refused {what}")
        want = plain_scores(*ops)
        torch.cuda.synchronize()
        for tier in ("mma", "scalar"):
            err = max(err, producer_vs_plain(ops, want, tier, what))
    say("producer=plain", cases="|".join(w for w, _ in cases), tiers="mma,scalar",
        result="bit-equal(NaN-poisoned outputs)", seconds=round(time.perf_counter() - t0, 3))
    return err


def chain_values(rng, shape):
    """Inputs of the chain probes: values near 1 (whose chains of 131072
    links pass 1e-38 near link 87,500 and end subnormal), both signs, above
    1000 (where ``v - 1.0`` wins the max), and 1e-36, zeros and 1e30."""
    import numpy as np
    import torch

    x = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    flat[: n // 4] = rng.uniform(900.0, 5000.0, size=n // 4)
    flat[n // 4 : n // 2] = -flat[n // 4 : n // 2]
    flat[n // 2 : n // 2 + 6] = [1e-36, -1e-36, 0.0, -0.0, 1000.0, 1e30]
    rng.shuffle(flat)
    return torch.from_numpy(x)


def bit_equal(got, want, what) -> float:
    """Raise unless the two f32 tensors hold the same bits; the largest
    difference (0.0)."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{what} differs from plain")
    return float((got - want).abs().max())


def phase_probes_vs_plain(dev) -> dict:
    """The three probes against their plain versions, bit for bit, at the
    shapes the utilization and wprobe configs run them (K9 at each of its
    four TPU blocks on the full tensor and at the producer's pattern at
    B64), each timed beside its plain version (and K9 beside
    ``torch.full``)."""
    import numpy as np
    import torch

    from praline_tpu_torch import bench
    from praline_tpu_torch.kernels import probes

    rng = np.random.default_rng(SEED + 12)
    out = {}
    t0 = time.perf_counter()
    x = chain_values(rng, bench.SMEM_SHAPE).to(dev)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(probes.smem_chain_plain(x, bench.SMEM_LINKS)), 1,
                       warm_up=False)
    got = probes.smem_chain(x, bench.SMEM_LINKS)
    err = bit_equal(got, plain[0], "smem_chain")
    subnormal = int(((got.abs() < 1.1754944e-38) & (got != 0)).sum())
    if not subnormal:
        raise AssertionError("smem_chain: no chain reached the subnormal range")
    n = x.numel()
    out["smem_chain"] = {
        "err": err, "plain_ms": plain_ms,
        "ms": cuda_ms(lambda: probes.smem_chain(x, bench.SMEM_LINKS), 3),
        **bound(2 * n * 4, n * bench.SMEM_LINKS * bench.OPS_PER_LINK)}
    say("probe=plain", kernel="smem_chain", shape=list(bench.SMEM_SHAPE), links=bench.SMEM_LINKS,
        result="bit-equal", subnormal_results=subnormal,
        **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in out["smem_chain"].items()})

    x = chain_values(rng, bench.ALU_SHAPE).to(dev)
    nacc, links = probes.NACC, bench.ALU_LINKS
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(probes.alu_chains_plain(x, links)), 1,
                       warm_up=False)
    err = bit_equal(probes.alu_chains(x, links), plain[0], "alu_chains")
    n = x.numel()
    out["alu_chains"] = {
        "err": err, "plain_ms": plain_ms,
        "ms": cuda_ms(lambda: probes.alu_chains(x, links), 3),
        # the seeds (nacc multiplies), the links, the sum (nacc - 1 adds)
        **bound(2 * n * 4, n * (nacc * links * bench.OPS_PER_LINK + 2 * nacc - 1))}
    say("probe=plain", kernel="alu_chains", shape=list(bench.ALU_SHAPE), nacc=nacc, links=links,
        result="bit-equal",
        **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in out["alu_chains"].items()})

    small = (20, 300, 1100)
    for block in (*bench.WPROBE_BLOCKS.values(), (3, 100, 77)):
        for value in (-0.0, 2.5):
            xv = torch.tensor([[value]], device=dev)
            want = probes.write_blocks_plain(xv, torch.empty(small, device=dev))
            bit_equal(probes.write_blocks(xv, small, block), want, f"write_blocks {block}")
    hs = torch.empty((2 * 300 + 1, 5, 301), device=dev)
    xv = torch.tensor([[2.5]], device=dev)
    bit_equal(probes.write_blocks(xv, block=probes.HS_BLOCK, out=probes.hs_pattern_view(hs)),
              torch.full(hs.shape, 2.5, device=dev).permute(1, 0, 2), "write_blocks hs pattern")
    del hs
    # An unaligned strided view (rows start 12 bytes past a 16-byte
    # boundary, ragged heads and tails), -0.0, every TPU block and a ragged
    # one: the view written, nothing around it.
    base = torch.full((7, 303, 517), float("nan"), device=dev)
    xv = torch.tensor([[-0.0]], device=dev)
    want = base.clone()
    want[1:6, 2:300, 3:514] = -0.0
    for block in (*bench.WPROBE_BLOCKS.values(), (2, 37, 101)):
        base.fill_(float("nan"))
        probes.write_blocks(xv, block=block, out=base[1:6, 2:300, 3:514])
        bit_equal(base, want, f"write_blocks {block} on an unaligned view")
    del base, want
    # The wprobe path's own shapes: every TPU block on its full tensor and
    # the producer's pattern at B64 (the path holds its headline chunk
    # itself, bench.assert_filled), each output poisoned first.
    shape = bench.WPROBE_SHAPE
    xv = torch.tensor([[1.5]], device=dev)
    ref = torch.empty(shape, device=dev)
    plain_ms = cuda_ms(lambda: probes.write_blocks_plain(xv, ref), 3)
    big = torch.empty(shape, device=dev)
    times = {}
    for name, block in bench.WPROBE_BLOCKS.items():
        big.fill_(float("nan"))
        times[name] = cuda_ms(lambda: probes.write_blocks(xv, block=block, out=big), 5)
        err = bit_equal(big, ref, f"write_blocks {name} on {shape}")
    del ref
    library_ms = cuda_ms(lambda: torch.full(shape, 1.5, device=dev), 5)
    again_ms = cuda_ms(lambda: probes.write_blocks(xv, block=(16, 128, 128), out=big), 5)
    del big
    hs = torch.full((2 * HEADLINE_BUCKET + 1, 64, HEADLINE_BUCKET + 1), float("nan"), device=dev)
    probes.write_blocks(xv, block=probes.HS_BLOCK, out=probes.hs_pattern_view(hs))
    bit_equal(hs, probes.write_blocks_plain(xv, torch.empty_like(hs)), "write_blocks hs pattern B64")
    del hs
    out["write_blocks"] = {"err": err, "ms": times["16x128x128"], "again_ms": again_ms,
                           "plain_ms": plain_ms, "library_ms": library_ms,
                           **bound(4 + 4 * float(np.prod(shape)), 0.0)}
    say("probe=plain", kernel="write_blocks", small=list(small),
        blocks="|".join(bench.WPROBE_BLOCKS) + "|3x100x77", full_shape=list(shape),
        full_blocks_ms=",".join(f"{k}:{v:.4f}" for k, v in times.items()),
        hs_pattern=f"B5x301,B64x{HEADLINE_BUCKET}", unaligned_view="7x303x517[1:6,2:300,3:514]",
        values="-0.0,2.5,1.5", result="bit-equal",
        seconds=round(time.perf_counter() - t0, 3),
        **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in out["write_blocks"].items()})
    return out


def tracks_runner(dev):
    """``bench.py``'s ``tracks`` workload (its first pair set) as a
    function that aligns it once, scores only or with traceback."""
    import torch

    from praline_tpu_torch.bench import tracks_workload
    from praline_tpu_torch.kernels.batch import align_tracksets_batched

    sets, cells, mats, w = tracks_workload()

    def run(traceback=False):
        out = align_tracksets_batched(sets[0], mats, w, (11, 1), "global", device=dev,
                                      traceback=traceback, bucket_sizes=(HEADLINE_BUCKET,))
        torch.cuda.synchronize()
        return out

    return sets[0], cells[0], mats, w, run


def run_tracks(run, cells, n, traceback):
    """The composite path ``n`` times on the two-kernel route (see
    :func:`timed_runs`).  Returns the results and the chunks of all runs."""
    import numpy as np

    from praline_tpu_torch.kernels import batch

    res, walls, gcs = timed_runs(lambda: run(traceback), n, "two_kernel")
    chunks = batch.route_counts["two_kernel"]
    if not all(np.isfinite(r.score) for r in res):
        raise AssertionError("tracks: a non-finite score")
    say("tracks", pairs=len(res), tracks="blosum62,pam250", weights="1.0,0.5", gap_series="11,1",
        mode="global", traceback=traceback, chunks_a_run=chunks // n, cells=int(cells),
        walls_s=",".join(f"{w:.4f}" for w in walls), gc_s=",".join(f"{g:.4f}" for g in gcs),
        cells_per_s=f"{cells / min(walls):.4e}")
    return res, chunks


def check_tracks(dev, pairs, mats, w, res, res_tb) -> None:
    """16 sampled composite problems against the plain composition on the
    card (plain producer per track, weighted sum, plain DP with traceback,
    plain walk); every traceback run's score equal to the scores run's."""
    import numpy as np

    from praline_tpu_torch.convert import matrix_to_torch, profiles_to_stack
    from praline_tpu_torch.kernels.replay import moves_to_result, replay_moves_plain
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.scores import composite_skewed_scores

    t0 = time.perf_counter()
    if any(a.score != b.score for a, b in zip(res, res_tb)):
        raise AssertionError("tracks: the traceback run's scores differ from the scores run's")
    sample = np.random.default_rng(SEED + 11).choice(len(pairs), 16, replace=False)
    sides = []
    for side in (0, 1):
        stacks = [profiles_to_stack([pairs[i][side][t] for i in sample], HEADLINE_BUCKET, dev)
                  for t in range(len(mats))]
        sides.append(stacks)
    lx, ly = sides[0][0][2], sides[1][0][2]
    hs = composite_skewed_scores([st[0] for st in sides[0]], [st[1] for st in sides[0]],
                                 [st[0] for st in sides[1]], [st[1] for st in sides[1]],
                                 [matrix_to_torch(m, dev) for m in mats], w)
    want = plain_dp(hs, lx, ly, (11, 1), "global", True)
    moves, nmoves = replay_moves_plain(want["tb"], want["ti"], want["tj"], want["tcode"],
                                       (11, 1), "global", 2 * HEADLINE_BUCKET)
    for k, i in enumerate(sample):
        exp = tuple(want[key][k].item() for key in ("score", "length", "ti", "tj"))
        if (res[i].score, res[i].length, res[i].ti, res[i].tj) != exp:
            raise AssertionError(f"tracks problem {i}: {res[i]} != plain {exp}")
        path = moves_to_result(moves[k].cpu().numpy(), int(nmoves[k]), exp[0], exp[2], exp[3],
                               int(lx[k]), int(ly[k]), "global")
        if not (np.array_equal(path.cols_x, res_tb[i].cols_x)
                and np.array_equal(path.cols_y, res_tb[i].cols_y)):
            raise AssertionError(f"tracks problem {i}: traceback columns differ from plain")
    say("tracks=plain", sampled="16/16 bit-equal (scores, lengths, terminals, columns)",
        seconds=round(time.perf_counter() - t0, 3))


def phase_bench(dev, name):
    """The port's bench config ``name`` at its full size, its numbers on a
    line of their own."""
    from praline_tpu_torch import bench

    t0 = time.perf_counter()
    out = bench.CONFIGS[name](dev)
    flat = {k: (json.dumps(v) if isinstance(v, (dict, list)) else v) for k, v in out.items()}
    say(name, seconds=round(time.perf_counter() - t0, 3), **flat)
    return out


def phase_fused_long(dev, timing):
    """The fused kernel where the two-kernel route refuses or the hs tensor
    would be large, held against the plain composition (which builds hs)."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_dp import fused_geometry, wavefront_dp_fused_plain

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    rng = np.random.default_rng(SEED + 2)
    for B, bx, by, lo, mode in FUSED_LONG_SHAPES:
        t0 = time.perf_counter()
        ops = stacked_operands(rng, dev, s, B, bx, by, lo)
        want = wavefront_dp_fused_plain(*ops, (11, 1), mode, True)
        what = f"{mode} B{B}x{bx}x{by}"
        for w in (want, scores_only(want)):
            timing["fused_err"] = max(timing["fused_err"], fused_vs_plain(ops, (11, 1), mode, w, what))
        g = fused_geometry(bx + 1, 2)
        say("fused=plain", shape=f"B{B}x{bx}x{by}", mode=mode, lanes=bx + 1, ctas=g.R, cta_lanes=g.W,
            tiers="mma,scalar", result="bit-equal(scores, all tb bytes; NaN-poisoned)",
            seconds=round(time.perf_counter() - t0, 3))


# (B, Lx, Ly, mode, series) of the fused kernel at each cluster size R = 1
# .. 8: Lx + 1 = 512 R lanes, every CTA full.
FUSED_CLUSTER_SHAPES = tuple((2, 512 * R - 1, 150, MODES[R % 3], SWEEP_SERIES[R % 3])
                             for R in range(1, 9))
# Scores mode with lx <= 700 at 2048 lanes: ranks 2 and 3 of 4 have no lane
# to compute and run only the barriers.
FUSED_IDLE_RANKS = (4, 2047, 300, 700)


def phase_fused_clusters(dev, timing):
    """The fused kernel at every cluster size against the plain version,
    scores and traceback, both tiers, NaN-poisoned; and in scores mode with
    lx leaving the high ranks no lanes, every mode."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_dp import fused_geometry, wavefront_dp_fused_plain

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    rng = np.random.default_rng(SEED + 14)
    t0, sizes = time.perf_counter(), []
    for B, bx, by, mode, series in FUSED_CLUSTER_SHAPES:
        ops = stacked_operands(rng, dev, s, B, bx, by, 1)
        want = wavefront_dp_fused_plain(*ops, series, mode, True)
        for w in (want, scores_only(want)):
            timing["fused_err"] = max(timing["fused_err"], fused_vs_plain(
                ops, series, mode, w, f"{mode} {series} B{B}x{bx}x{by}"))
        g = fused_geometry(bx + 1, len(series))
        sizes.append(f"R{g.R}:{bx}x{by}:{mode}:{','.join(map(str, series))}")
    B, bx, by, cap = FUSED_IDLE_RANKS
    ops = list(stacked_operands(rng, dev, s, B, bx, by, 1))
    ops[5] = torch.clamp(ops[5], max=cap)
    for mode in MODES:
        want = wavefront_dp_fused_plain(*ops, (11, 1), mode)
        timing["fused_err"] = max(timing["fused_err"], fused_vs_plain(
            ops, (11, 1), mode, want, f"{mode} lx<={cap} B{B}x{bx}x{by}"))
    g = fused_geometry(bx + 1, 2)
    say("fused=plain-clusters", shapes="|".join(sizes), tiers="mma,scalar",
        idle_ranks=f"B{B}x{bx}x{by} lx<={cap}: ranks {-(-(cap + 1) // g.W)}-{g.R - 1} of {g.R} "
                   f"idle, {','.join(MODES)} scores",
        result="bit-equal(scores, all tb bytes; NaN-poisoned)",
        seconds=round(time.perf_counter() - t0, 3))


def scores_only(want: dict) -> dict:
    """A plain traceback run's terminals: the scores-only run's outputs
    (the plain DP's terminals do not depend on its traceback flag)."""
    return {k: v for k, v in want.items() if k != "tb"}


def fused_vs_plain(ops, series, mode, want, what) -> float:
    """The fused kernel on both score tiers, each into NaN-poisoned outputs
    (traceback where ``want`` has ``tb``), held bit for bit against the
    plain version's ``want``; the largest score difference (0.0)."""
    import torch

    from praline_tpu_torch.kernels import fused_dp

    err = 0.0
    for tier in fused_dp.TIERS:
        out = {k: torch.full_like(v, float("nan") if v.is_floating_point()
                                  else 0xAB if v.dtype == torch.uint8 else -7)
               for k, v in want.items()}
        before = fused_dp.launches[tier]
        fused_dp.wavefront_dp_fused(*ops, series, mode, "tb" in want, tier=tier, out=out)
        if fused_dp.launches[tier] != before + 1:
            raise AssertionError(f"fused {tier}: no launch counted")
        err = max(err, same_outputs(out, want, f"fused {tier} {what}"))
    return err


# (B, bucket, shortest length, traceback runs) of the fused kernel's times:
# the headline chunk, a merge level past the two-kernel lane cap, and the
# long32 family's all-pairs bucket (lengths 1800-2397 take the stepped
# buckets 2047 .. 2431; 2303 holds the middle of them).
FUSED_TIMES = ((64, 1023, 512, (False, True)), (2, 2047, 1024, (True,)),
               (32, 2303, 1800, (False,)))


def phase_fused_times(dev):
    """The fused kernel on both tiers (in turns: mma, scalar, mma) beside
    the two-kernel route (producer + DP) where it takes the rows, the
    tiled kernel over the producer's hs, and, at the two smaller shapes,
    the plain composition, at FUSED_TIMES."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels import wavefront
    from praline_tpu_torch.kernels.fused_dp import (
        fused_geometry, wavefront_dp_fused, wavefront_dp_fused_plain,
    )
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.tiled_dp import wavefront_dp_tiled

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    rng = np.random.default_rng(SEED + 3)
    out = {}
    for B, bx, lo, modes in FUSED_TIMES:
        t0 = time.perf_counter()
        ops = stacked_operands(rng, dev, s, B, bx, bx, lo)
        tier = producer_tier(ops)
        if tier != "mma":
            raise AssertionError(f"the tensor-core predicate refused B{B}x{bx}")
        g = fused_geometry(bx + 1, 2)
        for tb in modes:
            tag = f"B{B}x{bx}x{bx}_{'traceback' if tb else 'scores'}"
            args = (ops[5], ops[6], (11, 1), "global", tb)
            def fused(score_tier):
                return wavefront_dp_fused(*ops, (11, 1), "global", tb, tier=score_tier)

            d = out[tag] = {"ctas": g.R, "cta_lanes": g.W, "fused_ms": cuda_ms(lambda: fused("mma"), 5),
                            "fused_scalar_ms": cuda_ms(lambda: fused("scalar"), 5)}
            if bx + 1 <= wavefront.MAX_LANES:
                d["two_kernel_ms"] = cuda_ms(lambda: wavefront.wavefront_dp(
                    fused_skewed_scores(*ops[:5], tier=tier), *args), 5)
            d["producer_tiled_ms"] = cuda_ms(lambda: wavefront_dp_tiled(
                fused_skewed_scores(*ops[:5], tier=tier), *args), 3)
            d["fused_again_ms"] = cuda_ms(lambda: fused("mma"), 5)
            if B * bx <= 64 * 1023:
                d["plain_ms"] = cuda_ms(lambda: wavefront_dp_fused_plain(*ops, (11, 1), "global", tb),
                                        1, warm_up=False)
            d.update(fused_bound(ops, fused("mma"), "mma"))
            d["scalar_bound_ms"] = fused_bound(ops, fused("scalar"), "scalar")["bound_ms"]
        say("fused-times", shape=f"B{B}x{bx}x{bx}", seconds=round(time.perf_counter() - t0, 3),
            **{f"{t}_{k}": (round(v, 4) if isinstance(v, float) else v)
               for t, d in out.items() if t.startswith(f"B{B}x") for k, v in d.items()})
    return out


def phase_tiled_vs_plain(dev) -> float:
    """The tiled kernel against its plain version at TILED_SHAPE: every
    mode, SWEEP_SERIES, both score sources (hs from the producer, and in
    place), scores and traceback, at each of TILED_CONFIGS.  The plain
    version's result does not depend on the tiling, so it runs once a case
    (256-lane tiles, 32 diagonals a visit)."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.tiled_dp import wavefront_dp_tiled, wavefront_dp_tiled_plain

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    rng = np.random.default_rng(SEED + 6)
    B, bx, by, lo = TILED_SHAPE
    err, t0 = 0.0, time.perf_counter()
    for mode in MODES:
        for series in SWEEP_SERIES:
            ops = stacked_operands(rng, dev, s, B, bx, by, lo)
            hs = fused_skewed_scores(*ops[:5], tier=producer_tier(ops))
            for tb in (False, True):
                want = wavefront_dp_tiled_plain(ops[:5], ops[5], ops[6], series, mode, tb,
                                                tile_lanes=256, steps_per_visit=32)
                for w, t in TILED_CONFIGS:
                    for name, source in (("hs", hs), ("in-place", ops[:5])):
                        got = wavefront_dp_tiled(source, ops[5], ops[6], series, mode, tb,
                                                 tile_lanes=w, steps_per_visit=t)
                        err = max(err, same_outputs(
                            got, want, f"tiled {name} {mode} {series} traceback={tb} "
                                       f"tile={w} T={t} B{B}x{bx}x{by}"))
    say("tiled=plain", shape=f"B{B}x{bx}x{by}", modes=",".join(MODES),
        series="|".join(",".join(map(str, g)) for g in SWEEP_SERIES), sources="hs,in-place",
        tile_lanes_and_T="|".join(f"{w},{t}" for w, t in TILED_CONFIGS), traceback="both",
        result="bit-equal(all outputs, all tb bytes)", seconds=round(time.perf_counter() - t0, 3))
    return err


def phase_tiled_long(dev) -> dict:
    """One problem past the fused kernel's 4096 lanes, with traceback: the
    tiled kernel (default tiles, hs source) against the plain DP, each
    timed."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores
    from praline_tpu_torch.kernels.tiled_dp import tile_width, wavefront_dp_tiled

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    B, bx, by, lo, mode = TILED_LONG
    t0 = time.perf_counter()
    ops = stacked_operands(np.random.default_rng(SEED + 8), dev, s, B, bx, by, lo)
    hs = plain_scores(*ops[:5])
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(plain_dp(hs, ops[5], ops[6], (11, 1), mode, True)),
                       1, warm_up=False)
    got = wavefront_dp_tiled(hs, ops[5], ops[6], (11, 1), mode, True)
    err = same_outputs(got, plain[0], f"tiled {mode} traceback B{B}x{bx}x{by}")
    ms = cuda_ms(lambda: wavefront_dp_tiled(hs, ops[5], ops[6], (11, 1), mode, True), 3)
    out = {"err": err, "ms": ms, "plain_ms": plain_ms, **dp_bound(ops[5], ops[6], got)}
    W = tile_width(bx + 1)
    say("tiled-long", shape=f"B{B}x{bx}x{by}", mode=mode, lanes=bx + 1, tile_lanes=W,
        tiles=-(-(bx + 1) // W), traceback="bit-equal to the plain DP (all tb bytes)",
        tiled_ms=round(ms, 4), plain_dp_ms=round(plain_ms, 4),
        bound_ms=round(out["bound_ms"], 4), bound_by=out["bound_by"],
        seconds=round(time.perf_counter() - t0, 3))
    return out


def phase_tiled_times(dev):
    """The tiled kernel (hs source: alone, and after the producer that
    feeds it; in place), the fused kernel and the plain composition at
    B2 x 3000 x 3000, where both kernels take the rows; then the tiled
    kernel beside the whole-row DP at TILED_VS_DP_SHAPES."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_dp import wavefront_dp_fused, wavefront_dp_fused_plain
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.tiled_dp import tile_width, wavefront_dp_tiled
    from praline_tpu_torch.kernels.wavefront import wavefront_dp

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    B, bx, lo = TILED_TIMES_SHAPE
    t0 = time.perf_counter()
    ops = stacked_operands(np.random.default_rng(SEED + 9), dev, s, B, bx, bx, lo)
    tier = producer_tier(ops)
    hs = fused_skewed_scores(*ops[:5], tier=tier)
    out = {}
    for tb in (False, True):
        tag = "traceback" if tb else "scores"
        args = (ops[5], ops[6], (11, 1), "global", tb)
        out[f"{tag}_tiled_ms"] = cuda_ms(lambda: wavefront_dp_tiled(hs, *args), 5)
        out[f"{tag}_producer_tiled_ms"] = cuda_ms(
            lambda: wavefront_dp_tiled(fused_skewed_scores(*ops[:5], tier=tier), *args), 5)
        out[f"{tag}_tiled_in_place_ms"] = cuda_ms(lambda: wavefront_dp_tiled(ops[:5], *args), 5)
        out[f"{tag}_fused_ms"] = cuda_ms(
            lambda: wavefront_dp_fused(*ops, (11, 1), "global", tb, tier="mma"), 5)
        out[f"{tag}_fused_scalar_ms"] = cuda_ms(
            lambda: wavefront_dp_fused(*ops, (11, 1), "global", tb, tier="scalar"), 5)
        out[f"{tag}_tiled_again_ms"] = cuda_ms(lambda: wavefront_dp_tiled(hs, *args), 5)
    out["traceback_plain_ms"] = cuda_ms(
        lambda: wavefront_dp_fused_plain(*ops, (11, 1), "global", True), 1, warm_up=False)
    say("tiled-times", shape=f"B{B}x{bx}x{bx}", mode="global", seconds=round(time.perf_counter() - t0, 3),
        **{k: round(v, 4) for k, v in out.items()})
    for B, bx, lo in TILED_VS_DP_SHAPES:
        t0 = time.perf_counter()
        ops = stacked_operands(np.random.default_rng(SEED + 10), dev, s, B, bx, bx, lo)
        hs = fused_skewed_scores(*ops[:5], tier=producer_tier(ops))
        out = {}
        for tb in (False, True):
            tag = "traceback" if tb else "scores"
            args = (ops[5], ops[6], (11, 1), "global", tb)
            out[f"{tag}_dp_ms"] = cuda_ms(lambda: wavefront_dp(hs, *args), 5)
            out[f"{tag}_tiled_ms"] = cuda_ms(lambda: wavefront_dp_tiled(hs, *args), 5)
            out[f"{tag}_dp_again_ms"] = cuda_ms(lambda: wavefront_dp(hs, *args), 5)
        say("tiled-vs-dp", shape=f"B{B}x{bx}x{bx}", mode="global", tile_lanes=tile_width(bx + 1),
            seconds=round(time.perf_counter() - t0, 3), **{k: round(v, 4) for k, v in out.items()})
        del hs


def phase_goldens(dev):
    """The 8 goldens byte-equal through the fused route (knob 1), then
    through the two-kernel route (knob 0)."""
    from praline_tpu_torch import (
        ALPHABET_AA, ALPHABET_DNA, PralineConfig, builtin_score_matrix,
        format_alignment_clustal, format_alignment_fasta, load_sequence_fasta, msa_align,
    )
    from praline_tpu_torch.kernels import fused_dp, fused_scores, replay, wavefront

    td = ROOT / "testdata"
    for knob in ("1", "0"):
        before = (sum(fused_dp.launches.values()), sum(fused_scores.launches.values()),
                  wavefront.launches, replay.launches)
        t0 = time.perf_counter()
        with route_knob(knob):
            for family, tag, mname, kw in GOLDENS:
                alphabet = ALPHABET_DNA if family == "dna8" else ALPHABET_AA
                seqs = load_sequence_fasta(td / f"{family}.fasta", alphabet)
                aln = msa_align(seqs, builtin_score_matrix(mname), PralineConfig(**kw), device=dev)
                if format_alignment_fasta(aln) != (td / f"{family}.{tag}.golden.fasta").read_text():
                    raise AssertionError(f"{family}.{tag} (knob {knob}): FASTA differs from the golden")
                if format_alignment_clustal(aln) != (td / f"{family}.{tag}.golden.aln").read_text():
                    raise AssertionError(f"{family}.{tag} (knob {knob}): CLUSTAL differs from the golden")
        fused, scores, dp, walk = (a > b for a, b in zip(
            (sum(fused_dp.launches.values()), sum(fused_scores.launches.values()),
             wavefront.launches, replay.launches), before))
        if knob == "1" and not (fused and walk):
            raise AssertionError("goldens under PRALINE_FUSED_DP=1 did not launch the fused kernel")
        if knob == "0" and (fused or not (scores and dp and walk)):
            raise AssertionError("goldens under PRALINE_FUSED_DP=0 left the two-kernel route")
        say("goldens", route="fused" if knob == "1" else "two_kernel", cases=len(GOLDENS),
            result="byte-equal", seconds=round(time.perf_counter() - t0, 3))


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


def headline_pairs():
    """bench.py:63-97: 256 ragged count profiles (512-1023), 8192 pairs
    (the first of the headline's two pair sets)."""
    from praline_tpu_torch.bench import cells_workload

    matrix, sets, cells = cells_workload(B=HEADLINE_PAIRS, L=HEADLINE_BUCKET)
    return matrix, sets[0], cells[0]


def all_pairs_runner(dev, matrix, pairs):
    """The distance stage's dispatch at the headline workload, as a
    function that runs it once."""
    import torch

    from praline_tpu_torch.kernels.batch import ProfileArena, align_pairs_batched

    arena = ProfileArena(matrix.alphabet.size, (HEADLINE_BUCKET,), dev)

    def run():
        out = align_pairs_batched(
            pairs, matrix, (11, 1), "global", device=dev, traceback=False,
            bucket_sizes=(HEADLINE_BUCKET,), batch_pairs=HEADLINE_PAIRS, arena=arena,
        )
        torch.cuda.synchronize()
        return out

    return run


def timed_runs(run, n, route):
    """``run`` ``n`` times on ``route`` (the only route its chunks may
    take): the results, which every run must repeat, with each run's wall
    and garbage-collection seconds."""
    from praline_tpu_torch.kernels import batch

    walls, gcs, res = [], [], None
    batch.reset_route_counts()
    for _ in range(n):
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            out = run()
            walls.append(time.perf_counter() - t0)
        gcs.append(gc_clock.seconds)
        if res is not None and out != res:
            raise AssertionError(f"{route} route: two runs differ")
        res = out
    if batch.route_counts[route] < 1 or sum(batch.route_counts.values()) != batch.route_counts[route]:
        raise AssertionError(f"runs meant for the {route} route took {batch.route_counts}")
    return res, walls, gcs


def check_all_pairs(dev, matrix, pairs, res):
    """The headline's results: finite, and 64 sampled problems equal to
    the plain versions on the card."""
    import numpy as np

    from praline_tpu_torch.convert import matrix_to_torch, profiles_to_stack
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores

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


def say_all_pairs(route, cells, walls, gcs, **extra):
    wall = statistics.median(walls[1:])
    say("all-pairs", pairs=HEADLINE_PAIRS, bucket=HEADLINE_BUCKET, gap_series="11,1",
        mode="global", route=route, cells=int(cells),
        walls_s=",".join(f"{w:.4f}" for w in walls), gc_s=",".join(f"{g:.4f}" for g in gcs),
        warm_median_s=round(wall, 4), dp_cells_per_s=f"{cells / wall:.4e}", **extra)


def synthetic_family(n=FAMILY_SIZE, seed=SEED, root_len=1000, lo=600, hi=1000):
    """A root of ``root_len`` residues; each member takes 25% substitutions,
    two short insertions and deletions down to a length drawn from
    ``lo``-``hi``."""
    import numpy as np

    from praline_tpu_torch import ALPHABET_AA, Sequence

    rng = np.random.default_rng(seed)
    root = rng.integers(0, 20, size=root_len)
    seqs = []
    for k in range(n):
        toks = root.copy()
        sub = rng.random(toks.size) < 0.25
        toks[sub] = rng.integers(0, 20, size=int(sub.sum()))
        for _ in range(2):
            at = int(rng.integers(0, toks.size + 1))
            toks = np.insert(toks, at, rng.integers(0, 20, size=int(rng.integers(1, 4))))
        target = int(rng.integers(lo, hi + 1))
        while toks.size > target:
            cut = min(toks.size - target, int(rng.integers(1, 40)))
            at = int(rng.integers(0, toks.size - cut + 1))
            toks = np.delete(toks, np.arange(at, at + cut))
        seqs.append(Sequence(f"s{k:03d}", toks.astype(np.int32), ALPHABET_AA))
    return seqs


def run_msa_twice(dev, seqs, name):
    """``msa_align`` twice with the default config: every row degaps to
    its input and both runs give the same bytes.  Returns a third run for
    the profiler."""
    import numpy as np

    from praline_tpu_torch import (
        GAP, METRICS, PralineConfig, builtin_score_matrix, format_alignment_fasta, msa_align,
    )

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
            raise AssertionError(f"{name}: rows of unequal width")
        for seq, row in zip(seqs, rows):
            if not np.array_equal(row[row != GAP], seq.tokens):
                raise AssertionError(f"{name}: row {seq.name} does not degap to its input")
        texts.append(format_alignment_fasta(aln))
        say(name, run=run, sequences=len(seqs),
            lengths=f"{min(s.length for s in seqs)}-{max(s.length for s in seqs)}",
            columns=aln.num_columns, wall_s=round(wall, 4), gc_s=round(gc_clock.seconds, 4),
            **{f"{k}_s": v["seconds"] for k, v in stages.items()})
    if texts[0] != texts[1]:
        raise AssertionError(f"{name}: two runs gave different bytes")
    return lambda: msa_align(seqs, matrix, PralineConfig(), device=dev)


def phase_msa(dev):
    """``msa_align`` end to end on the 128-sequence family, twice."""
    return run_msa_twice(dev, synthetic_family(), "msa")


def long_family():
    """32 members of a 2400-residue root, lengths 1800-2400: rows and
    merged profiles past 2047 columns, which only the fused kernel takes
    on the card."""
    return synthetic_family(LONG_FAMILY_SIZE, SEED + 4, root_len=2400, lo=1800, hi=2400)


def long8_family():
    """8 members of a 5000-residue root, lengths 4300-5000 (a dynein heavy
    chain is about 4650): every row and merged profile past 4096 columns,
    which only the tiled kernel takes on the card."""
    return synthetic_family(LONG8_SIZE, SEED + 7, root_len=5000, lo=4300, hi=5000)


def check_long_family(dev, seqs, name, n_sample, route=None):
    """``n_sample`` sampled all-pairs problems of a long family through the
    batch driver (every chunk on ``route`` where one is named) against the
    plain composition."""
    import numpy as np

    from praline_tpu_torch import PralineConfig, builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch, profiles_to_stack
    from praline_tpu_torch.kernels import batch
    from praline_tpu_torch.kernels.fused_dp import wavefront_dp_fused_plain

    t0 = time.perf_counter()
    cfg = PralineConfig()
    matrix = builtin_score_matrix("blosum62")
    index = [(i, j) for i in range(len(seqs)) for j in range(i + 1, len(seqs))]
    sample = [index[k] for k in np.random.default_rng(SEED + 5).choice(len(index), n_sample,
                                                                       replace=False)]
    px = [seqs[i].one_hot_profile() for i, _ in sample]
    py = [seqs[j].one_hot_profile() for _, j in sample]
    batch.reset_route_counts()
    got = batch.align_pairs_batched(list(zip(px, py)), matrix, cfg.gap_series, cfg.distance_mode,
                                    device=dev, traceback=False,
                                    bucket_sizes=tuple(cfg.bucket_sizes))
    if route and sum(batch.route_counts.values()) != batch.route_counts[route]:
        raise AssertionError(f"{name}: sampled pairs meant for the {route} route took "
                             f"{batch.route_counts}")
    cx, ivx, lx = profiles_to_stack(px, max(p.length for p in px), dev)
    cy, ivy, ly = profiles_to_stack(py, max(p.length for p in py), dev)
    want = wavefront_dp_fused_plain(cx, ivx, cy, ivy, matrix_to_torch(matrix, dev), lx, ly,
                                    cfg.gap_series, cfg.distance_mode)
    for k, r in enumerate(got):
        exp = tuple(want[key][k].item() for key in ("score", "length", "ti", "tj"))
        if (r.score, r.length, r.ti, r.tj) != exp:
            raise AssertionError(f"{name} pair {sample[k]}: {r} != plain {exp}")
    say(name, routes=json.dumps(batch.route_counts),
        sampled_all_pairs_vs_plain=f"{n_sample}/{n_sample} bit-equal",
        seconds=round(time.perf_counter() - t0, 3))


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


KERNELS = ("scores_mma", "scores_scalar", "dp", "fused", "fused_mma", "fused_scalar", "tiled",
           "walk", "alu_chains", "smem_chain", "write_blocks")
# The kernels each main path must launch: the all-pairs headline on its
# default route (two-kernel) and forced onto the fused route, the three
# msa_align runs, the composites (the producer at least twice a chunk: see
# main), and the utilization and wprobe configs.  Only long8 has rows past
# the fused kernel's lanes; every other path must keep off the tiled kernel.
# Every path's profiles are integer counts the tensor-core predicate
# admits, so every producer and fused launch of a path takes the "mma"
# tier; the scalar tiers are launched and checked by the kernel phases alone.
PATH_KERNELS = {"all-pairs": ("scores_mma", "dp"), "all-pairs-fused-route": ("fused",),
                "msa128": ("scores_mma", "dp", "walk"), "long-family": ("fused", "walk"),
                "long8": ("scores_mma", "tiled", "walk"), "tracks": ("scores_mma", "dp"),
                "tracks-traceback": ("scores_mma", "dp", "walk"),
                "utilization": ("alu_chains", "smem_chain"), "wprobe": ("write_blocks",)}


def counted(name, phase):
    """Run ``phase`` with every launch count set to 0 just before it; return
    its result and the counts read just after."""
    from praline_tpu_torch.kernels import fused_dp, fused_scores, probes, replay, tiled_dp, wavefront

    modules = dict(zip(("dp", "tiled", "walk"), (wavefront, tiled_dp, replay)))
    for m in (*modules.values(), fused_dp, fused_scores, probes):
        m.reset_launches()
    result = phase()
    counts = ({f"scores_{k}": v for k, v in fused_scores.launches.items()}
              | {"fused": sum(fused_dp.launches.values())}
              | {f"fused_{k}": v for k, v in fused_dp.launches.items()}
              | {k: m.launches for k, m in modules.items()} | probes.launches)
    say("launches", path=name, **counts)
    missing = [k for k in PATH_KERNELS[name] if counts[k] < 1]
    if missing:
        raise AssertionError(f"{name}: kernels of the path never launched: {missing}")
    for kernel in ("scores", "fused"):
        if counts[f"{kernel}_scalar"]:
            raise AssertionError(f"{name}: {counts[f'{kernel}_scalar']} of "
                                 f"{counts[f'{kernel}_scalar'] + counts[f'{kernel}_mma']} {kernel} "
                                 "launches left the tensor-core tier")
    if name != "long8" and counts["tiled"]:
        raise AssertionError(f"{name}: rows of 4096 lanes or fewer took the tiled kernel")
    return result, counts


def main() -> int:
    smi = phase_environment()
    import torch

    from praline_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    os.environ.pop("PRALINE_FUSED_DP", None)  # the default routes, whatever the caller's
    phase_build()
    timing = phase_kernels_vs_plain(dev)
    phase_fused_long(dev, timing)
    phase_fused_clusters(dev, timing)
    fused_times = phase_fused_times(dev)
    tiled_err = phase_tiled_vs_plain(dev)
    tiled_long = phase_tiled_long(dev)
    phase_tiled_times(dev)
    phase_goldens(dev)
    probe_times = phase_probes_vs_plain(dev)
    matrix, pairs, cells = headline_pairs()
    all_pairs_run = all_pairs_runner(dev, matrix, pairs)
    long_seqs = long_family()
    long8_seqs = long8_family()
    track_pairs, track_cells, track_mats, track_w, tracks_run = tracks_runner(dev)

    # ---- the main paths: launches are counted per path, over its runs only ----
    (res, walls, gcs), c1 = counted(
        "all-pairs", lambda: timed_runs(all_pairs_run, HEADLINE_RUNS, "two_kernel"))
    msa_run, c2 = counted("msa128", lambda: phase_msa(dev))
    long_run, c3 = counted("long-family", lambda: run_msa_twice(dev, long_seqs, "long-family"))
    long8_run, c4 = counted("long8", lambda: run_msa_twice(dev, long8_seqs, "long8"))
    (tracks_res, chunks), c5 = counted("tracks", lambda: run_tracks(tracks_run, track_cells, 2, False))
    (tracks_tb, chunks_tb), c6 = counted(
        "tracks-traceback", lambda: run_tracks(tracks_run, track_cells, 1, True))
    _, c7 = counted("utilization", lambda: phase_bench(dev, "utilization"))
    _, c8 = counted("wprobe", lambda: phase_bench(dev, "wprobe"))
    # ---- end of the main paths ----
    paths = (c1, c2, c3, c4, c5, c6, c7, c8)
    launches = {k: sum(c[k] for c in paths) for k in KERNELS}
    for name, c, n in (("tracks", c5, chunks), ("tracks-traceback", c6, chunks_tb)):
        if c["scores_mma"] != 2 * n or c["dp"] != n:
            raise AssertionError(f"{name}: {c['scores_mma']} producer and {c['dp']} DP launches "
                                 f"for {n} chunks of two tracks")
    check_tracks(dev, track_pairs, track_mats, track_w, tracks_res, tracks_tb)
    check_all_pairs(dev, matrix, pairs, res)
    say_all_pairs("two_kernel", cells, walls, gcs, sampled_vs_plain="64/64 bit-equal")
    with route_knob("1"):
        (res_fused, walls, gcs), _ = counted(
            "all-pairs-fused-route", lambda: timed_runs(all_pairs_run, FUSED_ROUTE_RUNS, "fused"))
    if res_fused != res:
        raise AssertionError("all-pairs: the fused route differs from the two-kernel route")
    say_all_pairs("fused", cells, walls, gcs, results="equal to the two_kernel route")
    check_long_family(dev, long_seqs, "long-family", 16)
    check_long_family(dev, long8_seqs, "long8", 4, "tiled")
    phase_profile("all-pairs", all_pairs_run)
    phase_profile("msa", msa_run)
    phase_profile("long-family", long_run)
    phase_profile("long8", long8_run)
    phase_profile("tracks", tracks_run)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "praline_tpu"))
    if foreign:
        raise AssertionError(f"JAX or the JAX package was imported: {foreign[:5]}")

    headline = fused_times[f"B64x{HEADLINE_BUCKET}x{HEADLINE_BUCKET}_scores"]
    long32 = fused_times["B32x2303x2303_scores"]
    kernels = [
        {"name": "skewed_scores", "route": "cuda",
         "source": "praline_tpu_torch/csrc/scores_mma.cu",
         "replaces": "praline_tpu/kernels/fused_scores.py:359 (fused_skewed_scores_strip), "
                     "praline_tpu/kernels/fused_scores.py:119 (fused_skewed_scores)",
         "launches": launches["scores_mma"] + launches["scores_scalar"],
         "max_abs_err": max(timing["scores_err"], timing["scores_edge_err"]),
         "ms": timing["scores_ms"], "plain_ms": timing["scores_plain_ms"],
         **timing["scores_bound"], "library_ms": timing["scores_library_ms"],
         "hs_pattern_ms": timing["scores_hs_pattern_ms"],
         "hs_pattern_512_ms": timing["scores_hs_pattern_512_ms"],
         "variants": {
             "mma": {"source": "praline_tpu_torch/csrc/scores_mma.cu",
                     "launches": launches["scores_mma"],
                     "ms": [timing["scores_ms"], timing["scores_again_ms"]]},
             "scalar": {"source": "praline_tpu_torch/csrc/scores.cu",
                        "launches": launches["scores_scalar"],
                        "ms": timing["scores_scalar_ms"]}}},
        {"name": "wavefront_dp", "route": "cuda",
         "source": "praline_tpu_torch/csrc/wavefront_dp.cu",
         "replaces": "praline_tpu/kernels/strip.py:587 (wavefront_dp_strip), "
                     "praline_tpu/kernels/pallas_dp.py:628 (wavefront_dp_pallas)",
         "launches": launches["dp"], "max_abs_err": timing["dp_err"],
         "ms": timing["dp_ms"], "plain_ms": timing["dp_plain_ms"],
         **timing["dp_bound"], "library_ms": None},
        {"name": "replay_moves", "route": "cuda",
         "source": "praline_tpu_torch/csrc/replay.cu",
         "replaces": "praline_tpu/kernels/replay.py:131 (replay_moves, an XLA scan)",
         "launches": launches["walk"], "max_abs_err": timing["walk_err"],
         "ms": timing["walk_ms"], "plain_ms": timing["walk_plain_ms"],
         **timing["walk_bound"], "library_ms": None},
        {"name": "wavefront_dp_fused", "route": "cuda",
         "source": "praline_tpu_torch/csrc/fused_dp.cu",
         "replaces": "praline_tpu/kernels/fused_dp.py:70 (wavefront_dp_fused), "
                     "praline_tpu/kernels/chunked.py:26 (wavefront_dp_chunked), "
                     "praline_tpu/kernels/scan.py:106 (wavefront_dp_streamed)",
         "launches": launches["fused"], "max_abs_err": timing["fused_err"],
         "ms": headline["fused_ms"], "plain_ms": headline["plain_ms"],
         "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"], "library_ms": None,
         "two_kernel_ms": headline["two_kernel_ms"],
         "producer_tiled_ms": headline["producer_tiled_ms"],
         "variants": {
             "mma": {"launches": launches["fused_mma"],
                     "ms": [headline["fused_ms"], headline["fused_again_ms"]]},
             "scalar": {"launches": launches["fused_scalar"], "ms": headline["fused_scalar_ms"],
                        "bound_ms": headline["scalar_bound_ms"]}},
         "long32_bucket": {"shape": "B32x2303x2303", "ms": long32["fused_ms"],
                           "scalar_ms": long32["fused_scalar_ms"],
                           "producer_tiled_ms": long32["producer_tiled_ms"],
                           "bound_ms": long32["bound_ms"], "bound_by": long32["bound_by"]}},
        {"name": "wavefront_dp_tiled", "route": "cuda",
         "source": "praline_tpu_torch/csrc/tiled_dp.cu",
         "replaces": "praline_tpu/kernels/pallas_dp_tiled.py:448 (wavefront_dp_tiled)",
         "launches": launches["tiled"], "max_abs_err": max(tiled_err, tiled_long["err"]),
         "ms": tiled_long["ms"], "plain_ms": tiled_long["plain_ms"],
         "bound_ms": tiled_long["bound_ms"], "bound_by": tiled_long["bound_by"],
         "library_ms": None},
    ]
    for name, replaces in (("smem_chain", "bench.py:224 (bench_utilization.run_vmem)"),
                           ("alu_chains", "bench.py:256 (bench_utilization.run_alu)"),
                           ("write_blocks", "tools/onchip_wprobe.py:37 (make_writer)")):
        t = probe_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "praline_tpu_torch/csrc/probes.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": t["err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
