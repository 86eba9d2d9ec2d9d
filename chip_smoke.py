#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``praline_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the ten Hopper kernel sources (the score producer's two tiers,
tensor-core and scalar, wavefront DP, fused producer + DP and lane-tiled
DP on two sources, its checkpointed launches and the in-place composite,
each on a thread-block cluster a problem, traceback walk, the device
merge's profile composition, and the benchmark's probes) from
``praline_tpu_torch/csrc`` with nvcc, one process per source, with
``-Xptxas -v`` (registers and spills of the producers, the DPs, the probes
and the composition are printed, and the fused and tiled kernels'
cluster occupancy at every cluster size), and holds each kernel against its plain
PyTorch version on the card, bit for bit: both producer tiers at buckets
1023, 63x127 and 2047 and at the tensor-core predicate's edges (alphabets
4, 32 and 23, counts of 255, |T| = 32766, |H| just under 2**24, one-hot
profiles; each output NaN-poisoned first), the other kernels at buckets
1023, 63x127 and 2047, the DPs over every mode and three gap series at
63x127, the fused kernel on both score tiers (NaN-poisoned outputs) at
those shapes, past the two-kernel lane cap (3000x3000), at a long y
(600x4000), at every cluster size (1 to 8 CTAs) and with lx leaving the
high ranks idle, the tiled kernel against its plain version at 4 x
700x600 (every mode, four series of 1, 2, 3 and 15 levels, both score
sources, scores and traceback, NaN-poisoned, at every cluster size from 1
to 16 CTAs with 1, 2 or 3 tiles a CTA) and, on one 4600x4400 traceback
problem (at its default and three other geometries) and one 9000x500
problem in place, against the plain DP; the probes at the benchmark's
shapes (K7 f32[256, 1024] through 131072 links, into the subnormal range;
K8 f32[1056, 256], four chains of 131072 links; K9 at every
TPU write block on a small tensor and on f32[64, 17408, 1024], on an
unaligned strided view with -0.0, and at the producer's block).  It times
the fused kernel on both tiers beside the two-kernel route, the tiled
kernel over the producer's hs and the plain version at the headline
bucket, a merge level and the long family's bucket, the tiled kernel
beside the fused kernel at 3000x3000 and 2303x2303 and beside the
whole-row DP and the fused kernel at buckets 1023 and 2047, K9 beside
``torch.full``.  The DP over hs (K2/K4) is held against the plain DP on
both its geometries (throughput, built for four and for five CTAs an SM,
and latency) at the three buckets in every
mode at 1, 2, 3 and 15 gap levels, scores and traceback, NaN-poisoned, and
on problems at the band's edges; ``[dp-times]`` times it on its default
geometry and six others beside the tiled kernel over the same hs at the
headline chunk (2945 x 1023), B64 at buckets 1023 and 2047, the tracks
traceback chunk (256) and merge levels of 4 and 1 problems
and holds the lane slots the kernel counts as it runs against their model
(``python3 chip_smoke.py dp-times DIR`` runs that phase alone on the tree
at DIR, so that the parent's DP is timed in the same call).  It aligns the committed
goldens through the CUDA path on both routes (the PAM250 golden on the
per-level merge, as in the JAX package).  The compose kernel is held
against ``compose_plain`` bit for bit, every output poisoned, in the three
modes, on merge levels of 32 joins at capacities 1023 and msa128's first
rung, of 16 joins at long32's and of 1 and 4 joins at long8's (tapes from
the DP's traceback and
hand-made ones: an empty local walk, x moves alone, y moves alone), over
columns past COUNT_LIMIT.  The device-resident merge of msa128, long32 and
long8 is enqueued under ``torch.cuda.set_sync_debug_mode("error")``, its
rung, attempts and each level's score tier printed, byte-equal to the
per-level path on the same tree; the two are timed in alternating turns
(msa128 also on two other ladders).  Then it drives the main paths
at full size, with the launch counts set to 0 before each and read after
its own runs: the all-pairs distance stage on 8192 pairs of bucket 1023
(five runs on the default two-kernel route), ``msa_align`` on a seeded
128-sequence family of lengths 600-1000 (two runs), on a seeded
32-sequence family of lengths 1800-2400 (two runs), which needs the fused
kernel, and on 8 members of lengths 4300-5000 (two runs; the size of a
dynein heavy chain), which needs the tiled kernel, each merged by the
device walk (the compose kernel launched); the two-track
composite workload of ``bench.py``'s ``tracks`` config (1024 pairs of
one-hot profiles of 512-1023 residues, BLOSUM62 + PAM250 weighted 1 and
0.5; two runs scores only, then one with traceback, each its own path);
and the port's ``utilization`` and ``wprobe`` bench configs, whose rates
are printed.  After them, sampled problems of each all-pairs stage and 16
composite problems are held against the plain versions, and the headline
runs four more times forced onto the fused route, counted on their own,
to the same results.  The long routes (``[long=...]`` lines): at B2 x
3000 x 2800, in global and local modes, on the hs and rows sources, at R
= the default and 64 diagonals a block, the checkpointed forward launch's
terminals equal the traceback launch's, every block's resumed bytes its
rows of tb and the block walk's tapes ``replay_moves``'s; the forward
launch (terminals and snapshot), one resume and one block walk against
their plain versions; the in-place two-track composite against the tiled
kernel over the materialized composite and the plain DP; a titin-length
pair (34,350 aa) by the full traceback and checkpointed (budget lowered
in this process, enqueued under ``set_sync_debug_mode("error")``), byte
for byte, each timed with its peak memory.  Two more main paths: the
``long-routes`` path (DNA pairs of 72,000 nt, full traceback under the
scaled budget, and 75,000 nt, checkpointed unforced, each degapping to
its inputs, the second's score equal to the scores-only run's; then
``msa_align`` of a 4-member titin-length family unforced and forced, the
same FASTA) and the ``tracks-long`` path (two two-track composites of
26,000 residues a side, past the scaled hs budget: in place, then
checkpointed).  Two more, on the pair mesh of ``dist/``: ``[mesh]``, the
headline all-pairs through ``make_pair_mesh(1)`` equal to the unsharded
call, the two timed as warm medians in alternating turns, and msa128 with
``mesh_shape=(1,)`` (the per-level merge, sharded) byte-equal to msa128
merged by the device walk; and ``[homology]``, the CLI on msa128 with
``--blast-db`` and ``--preprofile global`` against a ``psiblast`` stub put
on PATH (hits drawn from a second seeded family), byte-equal to
``msa_align`` with the same hits from ``FakeBlastFinder``, the hits
changing exactly their members' preprofile counts.  ``[two-ranks]``
starts this script twice as ``two-ranks-rank`` (two processes on gloo,
both on ``cuda:0``, the kernels already built): msa128 on a mesh across
both with a shared checkpoint directory, long8's all-pairs stage (the
tiled route) and the ``tracks`` pairs, each equal to the single-process
results, only rank 0 writing checkpoints; a rank that fails or hangs past
its timeout fails the run.  The CLI runs msa128 with ``--profile-dir``, whose trace
must hold ``dispatch:`` spans.  ``python3 chip_smoke.py long-routes``
runs the build and these phases alone; ``python3 chip_smoke.py
tiled-times DIR`` times K6's ordinary launches on the tree at DIR alone
(for the parent beside this tree in one call).  One more run of each of the
first five main paths under ``torch.profiler`` gives the device time per
kernel and the busy share.
Every producer and fused launch of every main path but ``[homology]``'s must
take the tensor-core tier (the launches are counted per tier; homology's
preprofile counts pass the predicate's bounds once merged).  Every phase raises
on failure.  The host layers are reached only through
``praline_tpu_torch``; the run fails if JAX or the JAX package was
imported.  The last lines are a JSON summary of the kernels (with each
one's bound: the larger of the bytes its function must move over 3.35
TB/s, or through shared memory at 128 bytes an SM a clock, and its
operations: f32 lane-instructions at 128 an SM a clock, at the card's
maximum SM clock from ``nvidia-smi``, and int8 at the tensor cores'
published 1979 TOP/s), the card's name and power limit, and ``{"ok": true,
...}``.
Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# Turns of the device walk against the per-level path on each family's tree.
MERGE_TURNS = 4
LONG8_SIZE = 8
# (B, bucket_x, bucket_y, shortest length) of the kernel = plain checks:
# the headline bucket, a small ragged pair, and bucket 2047, the DP's
# widest rows (16 tiles; the merge levels of the msa run take it).
KERNEL_SHAPES = ((64, 1023, 1023, 512), (16, 63, 127, 1), (8, 2047, 2047, 1024))
MODES = ("global", "semiglobal", "local")
SWEEP_SERIES = ((11, 1), (13, 7, 1), (5,))
# (B, Lx, Ly, shortest length, mode) of the fused kernel's long checks, all
# with traceback: rows past the two-kernel DP's 2048 lanes, and a long y.
# The plain DP walks their 6000 and 4600 diagonals one at a time, so they
# are kept to two; global past 2048 lanes is held by the long family's
# sampled problems.
FUSED_LONG_SHAPES = ((2, 3000, 3000, 2500, "local"), (2, 600, 4000, 500, "semiglobal"))
# The tiled kernel against its plain version: (B, Lx, Ly, shortest length)
# (701 lanes: every tile width below leaves a ragged last tile), the gap
# series (k = 2, 3, 1 and 15), and the cluster sizes R = 1 .. 16, each with
# 1, 2 or 3 tiles a CTA (m = R % 3 + 1) and boxes of 32, 7 or 3 diagonals.
TILED_SHAPE = (4, 700, 600, 1)
TILED_SERIES = ((11, 1), (13, 7, 1), (5,), tuple(range(30, 0, -2)))
TILED_GEOMETRIES = tuple((R, min(512, -(-(-(-701 // (R * (R % 3 + 1)))) // 32) * 32),
                          (32, 7, 3)[R // 3 % 3]) for R in range(1, 17))
# One long traceback problem against the plain DP (rows past 4096 lanes),
# and the geometries timed beside the default there (CTAs, tile lanes): the
# portable cluster spread over 8 CTAs of two tiles, and the fewest CTAs of
# at most 512 lanes on a portable (5 CTAs of two tiles) and a non-portable
# cluster (10 CTAs of one tile).
TILED_LONG = (1, 4600, 4400, 4000, "local")
TILED_LONG_GEOMETRIES = ((8, 288), (5, 480), (10, 480))
# Scores mode past 8192 lanes on the rows source, against the plain DP:
# (B, Lx, Ly, shortest length, mode); two tiles a CTA.
TILED_PAST_8192 = (1, 9000, 500, 400, "global")
# (B, lanes - 1 = Lx = Ly, shortest length) where both the fused and the
# tiled kernel take the rows: their times side by side (3000: past the
# whole-row DP's lanes; 2303: the long32 family's all-pairs bucket).
TILED_TIMES_SHAPES = ((2, 3000, 2500), (32, 2303, 1800))
# (B, lanes - 1, shortest length) where the whole-row DP takes the rows at
# one and at two lanes a thread: the tiled and the fused kernels' times
# beside it.
TILED_VS_DP_SHAPES = ((64, 1023, 512), (64, 2047, 1024))
# The H100 SXM's published rates (NVIDIA's H100 datasheet): device memory
# and dense int8 on the tensor cores.  The f32 rate and the shared-memory
# rate are the card's own (card_rates, from its SM count and maximum SM
# clock): no kernel of the port issues an FMA (--fmad=false and the
# bit-exact contract), so an f32 operation is one lane-instruction, at 128
# lanes an SM a clock (the published 67 TFLOP/s counts an FMA as two); shared
# memory moves 128 bytes an SM a clock.  The DP's f32 operations a cell at k
# = 2: two subtracts, a compare and a length add per gap side, an add and a
# length add for M, two compares for the best state (selects not counted).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_LANES_PER_SM = 128
SMEM_BYTES_PER_SM_CLOCK = 128
DP_OPS_PER_CELL = 12
RATES: dict = {}  # card_rates()


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


def card_rates() -> dict:
    """The card's f32 lane-instruction rate and shared-memory byte rate: its
    SMs times 128 lanes (bytes) times its maximum SM clock
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    RATES.update(sms=sms, sm_clock_hz=mhz * 1e6,
                 f32_ops_per_s=sms * F32_LANES_PER_SM * mhz * 1e6,
                 smem_bytes_per_s=sms * SMEM_BYTES_PER_SM_CLOCK * mhz * 1e6)
    return RATES


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    if not (ROOT / "praline_tpu_torch" / "csrc").is_dir() or not (ROOT / "testdata").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    card_rates()
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
        triton=triton_version, gpu=repr(smi), devices=torch.cuda.device_count(),
        sms=RATES["sms"], sm_clock_max_hz=f"{RATES['sm_clock_hz']:.4e}",
        f32_ops_per_s=f"{RATES['f32_ops_per_s']:.4e}",
        smem_bytes_per_s=f"{RATES['smem_bytes_per_s']:.4e}")
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
    kernels = (("walk_kernel", "tiled_dp", "source", "hs", TILED_HS),
               ("walk_kernel", "tiled_dp", "source", "rows", TILED_ROWS),
               ("walk_kernel", "tiled_ckpt", "source", "hs", TILED_HS_CKPT),
               ("walk_kernel", "tiled_ckpt", "source", "rows", TILED_ROWS_CKPT),
               ("walk_kernel", "tiled_composite", "source", "composite", TILED_COMPOSITE),
               ("walk_kernel", "wavefront_dp", "min_blocks", 4, DP_WALK.format(n=4, k="{k}")),
               ("walk_kernel", "wavefront_dp", "min_blocks", 5, DP_WALK.format(n=5, k="{k}")),
               ("fused_cluster_kernel", "fused_dp", "tier", "mma", FUSED_MMA),
               ("fused_cluster_kernel", "fused_dp", "tier", "scalar", FUSED_SCALAR))
    for kernel, source, what, which, pattern in kernels:
        found = {}
        for k in (1, 2, 3, 15):
            found[f"K{k}"] = "{}regs/{}B-spill-stores/{}B-spill-loads".format(
                *kernel_usage(usage, pattern.format(k=k)))
        say("registers", kernel=kernel, file=source, **{what: which}, lanes_per_thread=1,
            **found)
    phase_cluster_occupancy()
    probes = {}
    for kernel in ("alu_chains_kernel", "smem_chain_kernel", "write_blocks_kernel",
                   "compose_kernel"):
        key = next((n for n in usage if kernel in n), None)
        if key is None:
            raise AssertionError(f"build: no -Xptxas -v line for {kernel}")
        probes[kernel.split("_kernel")[0]] = "{}regs/{}B-spill-stores/{}B-spill-loads".format(
            *usage[key])
    say("registers", kernel="probes and compose", **probes)
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
    return usage


# Mangled names of the DP kernels at k = {k} levels: the fused kernel on
# either tier, csrc/cluster_walk.cuh's walk_kernel<Src, K, BAND, MAXW, MINB,
# CKPT> as the tiled kernel (on hs or in place, 512 threads, with the
# checkpointed launches built in or not; walk_kernel_params on the
# composite) and as the DP over hs (the band on, 128 threads, at least {n}
# CTAs an SM).
FUSED_MMA = r"fused_cluster_kernelILi{k}ELb1E"
FUSED_SCALAR = r"fused_cluster_kernelILi{k}ELb0E"
TILED_HS = r"walk_kernelI.*HsSourceELi{k}ELb0ELi512ELi1ELb0E"
TILED_ROWS = r"walk_kernelI.*RowsSourceELi{k}ELb0ELi512ELi1ELb0E"
TILED_HS_CKPT = r"walk_kernelI.*HsSourceELi{k}ELb0ELi512ELi1ELb1E"
TILED_ROWS_CKPT = r"walk_kernelI.*RowsSourceELi{k}ELb0ELi512ELi1ELb1E"
TILED_COMPOSITE = r"walk_kernel_paramsI.*CompositeSourceELi{k}ELb0ELi512ELi1ELb1E"
DP_WALK = r"walk_kernelI.*HsSourceELi{k}ELb1ELi128ELi{n}E"


def kernel_usage(usage, pattern) -> tuple[int, int, int]:
    """(registers, spill store bytes, spill load bytes) of the one kernel
    whose mangled name matches ``pattern``, from the build's ``-Xptxas
    -v`` lines."""
    keys = [n for n in usage if re.search(pattern, n)]
    if len(keys) != 1:
        raise AssertionError(f"build: {len(keys)} -Xptxas -v lines for {pattern}")
    return usage[keys[0]]


def phase_cluster_occupancy():
    """The fused and the tiled kernels' clusters: for the fused kernel at R
    = 1 .. 8 CTAs (at Lp = 512 R), for the tiled kernel at R = 1 .. 16 CTAs
    (at Lp = 320 R, one tile of 320 lanes a CTA, and at Lp = 1024 R, two of
    512), at k = 2 and 15 on each tier or source, the shared
    memory a CTA (the kernel's layout and the Python geometry's, which must
    agree) and how many clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``, which must be at least 1)."""
    from praline_tpu_torch.kernels import build, fused_dp, tiled_dp

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
    for k in (2, 15):
        for source in tiled_dp.SOURCES:
            rows = []
            for R in range(1, tiled_dp.MAX_CTAS + 1):
                for lanes in (320, 1024):
                    g = tiled_dp.tiled_geometry(lanes * R, k, source, ctas=R)
                    kernel_smem = lib.praline_tiled_dp_smem(g.W, g.T, g.m, k, int(source == "hs"))
                    if kernel_smem != g.smem_bytes:
                        raise AssertionError(f"tiled smem {g} k={k} {source}: kernel "
                                             f"{kernel_smem} B")
                    clusters = tiled_dp.max_active_clusters(k, source, g)
                    if clusters < 1:
                        raise AssertionError(f"no cluster of {g} fits at k={k} on {source}")
                    rows.append(f"R{g.R}:m{g.m}:W{g.W}:{g.smem_bytes}B:"
                                f"{'L2' if g.carry_scratch else 'smem'}:{clusters}")
            say("clusters", kernel="walk_kernel", source_file="tiled_dp", k=k, score_source=source,
                T=tiled_dp.MAX_STEPS, R_m_W_smem_carries_active_clusters=",".join(rows))


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


def bound(nbytes: float, ops: float, int8_ops: float = 0.0, smem_bytes: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes' time
    (``nbytes`` over the memory rate, or ``smem_bytes`` through shared
    memory over its rate, whichever is longer; ``bytes_of`` says which) and
    the operations' time, ``ops`` f32 lane-instructions over the card's f32
    rate plus ``int8_ops`` tensor-core operations over the int8 rate."""
    t_hbm = nbytes / HBM_BYTES_PER_S * 1e3
    t_smem = smem_bytes / RATES["smem_bytes_per_s"] * 1e3
    t_bytes = max(t_hbm, t_smem)
    t_ops = (ops / RATES["f32_ops_per_s"] + int8_ops / INT8_OPS_PER_S) * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes",
                "bytes_of": "shared memory" if t_smem > t_hbm else "device memory"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


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
        # a link: a 4-byte shared-memory load and store a thread
        **bound(2 * n * 4, n * bench.SMEM_LINKS * bench.OPS_PER_LINK,
                smem_bytes=n * bench.SMEM_LINKS * 8)}
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


def tiled_vs_plain(source, lx, ly, series, mode, want, what, **geometry) -> float:
    """The tiled kernel into NaN-poisoned outputs (traceback where ``want``
    has ``tb``), held bit for bit against the plain version's ``want``; the
    largest score difference (0.0)."""
    import torch

    from praline_tpu_torch.kernels import tiled_dp

    out = {k: torch.full_like(v, float("nan") if v.is_floating_point()
                              else 0xAB if v.dtype == torch.uint8 else -7)
           for k, v in want.items()}
    before = tiled_dp.launches
    tiled_dp.wavefront_dp_tiled(source, lx, ly, series, mode, "tb" in want, out=out, **geometry)
    if tiled_dp.launches != before + 1:
        raise AssertionError("tiled: no launch counted")
    return same_outputs(out, want, f"tiled {what}")


def phase_tiled_vs_plain(dev) -> float:
    """The tiled kernel against its plain version at TILED_SHAPE: every
    mode, TILED_SERIES, both score sources (hs from the producer, and in
    place), scores and traceback, at each of TILED_GEOMETRIES, each output
    NaN-poisoned.  The plain version's result does not depend on the
    geometry, so it runs once a case (256-lane tiles, 32 diagonals a box)."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.tiled_dp import tiled_geometry, wavefront_dp_tiled_plain

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    rng = np.random.default_rng(SEED + 6)
    B, bx, by, lo = TILED_SHAPE
    err, t0, shapes, carries = 0.0, time.perf_counter(), set(), set()
    for mode in MODES:
        for series in TILED_SERIES:
            ops = stacked_operands(rng, dev, s, B, bx, by, lo)
            sources = (("hs", fused_skewed_scores(*ops[:5], tier=producer_tier(ops))),
                       ("rows", ops[:5]))
            want = wavefront_dp_tiled_plain(ops[:5], ops[5], ops[6], series, mode, True,
                                            tile_lanes=256, steps_per_visit=32)
            for R, W, T in TILED_GEOMETRIES:
                for name, source in sources:
                    g = tiled_geometry(bx + 1, len(series), name, ctas=R, tile_lanes=W, steps=T)
                    shapes.add((g.R, g.m, g.W, g.T))
                    carries.add("L2" if g.carry_scratch else "smem" if g.m > 1 else "registers")
                    for w in (want, scores_only(want)):
                        err = max(err, tiled_vs_plain(
                            source, ops[5], ops[6], series, mode, w,
                            f"{name} {mode} {series} traceback={'tb' in w} R={R} W={W} T={T} "
                            f"B{B}x{bx}x{by}", ctas=R, tile_lanes=W, steps_per_visit=T))
    if {R for R, *_ in shapes} != set(range(1, 17)) or {m for _, m, *_ in shapes} != {1, 2, 3} \
            or carries != {"registers", "smem", "L2"}:
        raise AssertionError(f"tiled=plain missed a cluster size, a tile count or a carry "
                             f"store: {sorted(shapes)} {carries}")
    say("tiled=plain", shape=f"B{B}x{bx}x{by}", lanes=bx + 1, modes=",".join(MODES),
        series="|".join(",".join(map(str, g)) for g in TILED_SERIES), sources="hs,rows",
        R_m_W_T="|".join(",".join(map(str, g)) for g in sorted(shapes)),
        carries=",".join(sorted(carries)), traceback="both",
        result="bit-equal(all outputs, all tb bytes; NaN-poisoned)",
        seconds=round(time.perf_counter() - t0, 3))
    return err


def phase_tiled_long(dev, usage) -> dict:
    """One problem past the fused kernel's 4096 lanes, with traceback: the
    tiled kernel (default geometry, hs source) against the plain DP, timed
    beside TILED_LONG_GEOMETRIES (each held to the same bits) and the rows
    source; then scores mode past 8192 lanes on the rows source
    (TILED_PAST_8192) against the plain DP."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_dp import wavefront_dp_fused_plain
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores
    from praline_tpu_torch.kernels.tiled_dp import tiled_geometry, wavefront_dp_tiled

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    B, bx, by, lo, mode = TILED_LONG
    t0 = time.perf_counter()
    ops = stacked_operands(np.random.default_rng(SEED + 8), dev, s, B, bx, by, lo)
    hs = plain_scores(*ops[:5])
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(plain_dp(hs, ops[5], ops[6], (11, 1), mode, True)),
                       1, warm_up=False)
    want = plain[0]

    def tiled(source=hs, **geometry):
        return wavefront_dp_tiled(source, ops[5], ops[6], (11, 1), mode, True, **geometry)

    err = tiled_vs_plain(hs, ops[5], ops[6], (11, 1), mode, want, f"{mode} B{B}x{bx}x{by}")
    ms = cuda_ms(tiled, 5)
    others = {}
    for R, W in TILED_LONG_GEOMETRIES:
        g = tiled_geometry(bx + 1, 2, ctas=R, tile_lanes=W)
        tiled_vs_plain(hs, ops[5], ops[6], (11, 1), mode, want, f"{mode} R={R} W={W}",
                       ctas=R, tile_lanes=W)
        others[f"R{g.R}_m{g.m}_W{g.W}_ms"] = cuda_ms(lambda: tiled(ctas=R, tile_lanes=W), 5)
    others["again_ms"] = cuda_ms(tiled, 5)
    tiled_vs_plain(ops[:5], ops[5], ops[6], (11, 1), mode, want, f"rows {mode} B{B}x{bx}x{by}")
    others["rows_ms"] = cuda_ms(lambda: tiled(ops[:5]), 3)
    out = {"err": err, "ms": ms, "plain_ms": plain_ms, **dp_bound(ops[5], ops[6], want)}
    g = tiled_geometry(bx + 1, 2)
    regs, spill_st, spill_ld = kernel_usage(usage, TILED_HS.format(k=2))
    out["geometry"] = {"R": g.R, "m": g.m, "W": g.W, "T": g.T, "smem_bytes": g.smem_bytes,
                       "registers": regs, "spill_stores": spill_st, "spill_loads": spill_ld}
    out["variants"] = others
    say("tiled-long", shape=f"B{B}x{bx}x{by}", mode=mode, lanes=bx + 1, R=g.R, m=g.m, W=g.W,
        T=g.T, registers=regs, spill_stores_B=spill_st, spill_loads_B=spill_ld,
        smem_B=g.smem_bytes, traceback="bit-equal to the plain DP (all tb bytes)",
        tiled_ms=round(ms, 4), plain_dp_ms=round(plain_ms, 4),
        bound_ms=round(out["bound_ms"], 4), bound_by=out["bound_by"],
        **{k: round(v, 4) for k, v in others.items()}, seconds=round(time.perf_counter() - t0, 3))
    del hs, plain, want

    B, bx, by, lo, mode = TILED_PAST_8192
    t0 = time.perf_counter()
    ops = stacked_operands(np.random.default_rng(SEED + 15), dev, s, B, bx, by, lo)
    want = wavefront_dp_fused_plain(*ops, (11, 1), mode)
    out["err"] = max(out["err"], tiled_vs_plain(ops[:5], ops[5], ops[6], (11, 1), mode, want,
                                                f"rows {mode} B{B}x{bx}x{by}"))
    g = tiled_geometry(bx + 1, 2, "rows")
    past = out["past_8192"] = {
        "shape": f"B{B}x{bx}x{by}", "R": g.R, "m": g.m, "W": g.W,
        "ms": cuda_ms(lambda: wavefront_dp_tiled(ops[:5], ops[5], ops[6], (11, 1), mode), 3)}
    say("tiled-long", shape=past["shape"], mode=mode, lanes=bx + 1, source="rows",
        R=g.R, m=g.m, W=g.W, scores="bit-equal to the plain DP", tiled_ms=round(past["ms"], 4),
        seconds=round(time.perf_counter() - t0, 3))
    return out


def phase_tiled_times(dev):
    """The tiled kernel (hs source: alone, and after the producer that
    feeds it; in place), the fused kernel on both tiers and, at 3000, the
    plain composition, at TILED_TIMES_SHAPES, where both kernels take the
    rows; then the tiled and the fused kernels beside the whole-row DP at
    TILED_VS_DP_SHAPES."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels.fused_dp import wavefront_dp_fused, wavefront_dp_fused_plain
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.tiled_dp import tiled_geometry, wavefront_dp_tiled
    from praline_tpu_torch.kernels.wavefront import wavefront_dp

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    results = {}
    for B, bx, lo in TILED_TIMES_SHAPES:
        t0 = time.perf_counter()
        ops = stacked_operands(np.random.default_rng(SEED + 9), dev, s, B, bx, bx, lo)
        tier = producer_tier(ops)
        hs = fused_skewed_scores(*ops[:5], tier=tier)
        out = {}
        for tb in (False, True) if B <= 2 else (False,):
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
        if B <= 2:
            out["traceback_plain_ms"] = cuda_ms(
                lambda: wavefront_dp_fused_plain(*ops, (11, 1), "global", True), 1, warm_up=False)
        g = tiled_geometry(bx + 1, 2)
        say("tiled-times", shape=f"B{B}x{bx}x{bx}", mode="global", R=g.R, m=g.m, W=g.W,
            seconds=round(time.perf_counter() - t0, 3), **{k: round(v, 4) for k, v in out.items()})
        results[f"B{B}x{bx}"] = out
        del hs
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
            out[f"{tag}_fused_ms"] = cuda_ms(
                lambda: wavefront_dp_fused(*ops, (11, 1), "global", tb, tier="mma"), 5)
            out[f"{tag}_dp_again_ms"] = cuda_ms(lambda: wavefront_dp(hs, *args), 5)
        g = tiled_geometry(bx + 1, 2)
        say("tiled-vs-dp", shape=f"B{B}x{bx}x{bx}", mode="global", R=g.R, m=g.m, W=g.W,
            seconds=round(time.perf_counter() - t0, 3), **{k: round(v, 4) for k, v in out.items()})
        results[f"B{B}x{bx}"] = out
        del hs
    return results


# The whole-row DP (K2/K4) against its plain version: the gap series of its
# checks (k = 2, 3, 1 and 15) and, at bucket 1023, problems at the band's
# edges (lx, ly): both lengths 1, lx << ly and lx >> ly, lx = Lp - 1, and ly
# = 34, 162 and 290 (2 mod 32), with which every full tile of 128 lanes
# leaves the band at the first diagonal of a box of 32 (ie + ly + 1 = 2 mod
# 32), so that the next tile's first lane enters the last column there.
DP_SERIES = ((11, 1), (13, 7, 1), (5,), tuple(range(30, 0, -2)))
DP_EDGES = ((1, 1), (1, 1023), (1023, 1), (3, 900), (1000, 5), (1023, 1023), (700, 34),
            (500, 162), (1023, 290), (128, 1), (129, 34))
# (B, bucket, shortest length, traceback) of the [dp-times] phase: the
# headline chunk (the batch driver's chunk of the 8192 headline pairs on an
# 80 GB card), the kernel phases' B64, bucket 2047, the tracks workload's
# traceback chunk, and merge levels of one and four problems.
DP_TIMES = ((2945, 1023, 512, False), (64, 1023, 512, False), (64, 1023, 512, True),
            (64, 2047, 1024, False), (64, 2047, 1024, True), (256, 1023, 512, True),
            (4, 1023, 512, True), (1, 1023, 512, True))
# Geometries timed beside the default at each DP_TIMES shape: (kind, CTAs a
# problem (None: the kind's), the kernel's launch bound of CTAs an SM).
DP_VARIANTS = (("throughput", None, 4), ("throughput", None, 5), ("latency", 2, 4),
               ("latency", 4, 4), ("latency", None, 4), ("latency", None, 5))


def poisoned(want: dict) -> dict:
    """Output tensors shaped as ``want``, filled with NaN (floats), 0xAB
    (traceback bytes) or -7 (integers)."""
    import torch

    return {k: torch.full_like(v, float("nan") if v.is_floating_point()
                               else 0xAB if v.dtype == torch.uint8 else -7)
            for k, v in want.items()}


def dp_vs_plain(hs, lx, ly, series, mode, want, what, geometry) -> float:
    """The whole-row DP on ``geometry`` into NaN-poisoned outputs
    (traceback where ``want`` has ``tb``), held bit for bit against the
    plain DP's ``want``."""
    from praline_tpu_torch.kernels import wavefront

    out = poisoned(want)
    before = wavefront.launches
    wavefront.wavefront_dp(hs, lx, ly, series, mode, "tb" in want, geometry=geometry, out=out)
    if wavefront.launches != before + 1:
        raise AssertionError("dp: no launch counted")
    return same_outputs(out, want, f"dp {what} {geometry}")


def phase_dp_vs_plain(dev) -> dict:
    """K2 against the plain DP at KERNEL_SHAPES in every mode, DP_SERIES,
    scores and traceback, on both geometries (the throughput one built for
    four and for five CTAs an SM), each output NaN-poisoned; then the band's
    edges (DP_EDGES) at bucket 1023 in every mode, scores and traceback.
    The geometry the batch driver takes for each shape is printed, with the
    cluster occupancy and the registers of each level count."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels import build, wavefront
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    rng = np.random.default_rng(SEED + 11)
    err, t0, seen = 0.0, time.perf_counter(), set()
    for B, bx, by, lo in KERNEL_SHAPES:
        for mode in MODES:
            for series in DP_SERIES:
                ops = stacked_operands(rng, dev, s, B, bx, by, lo)
                hs = fused_skewed_scores(*ops[:5], tier=producer_tier(ops))
                k = len(series)
                want = plain_dp(hs, ops[5], ops[6], series, mode, True)
                geometries = (wavefront.geometry("throughput", bx + 1, k),
                              wavefront.geometry("throughput", bx + 1, k, min_blocks=5),
                              wavefront.geometry("latency", bx + 1, k, ctas=3),
                              wavefront.geometry("latency", bx + 1, k))
                for g in geometries:
                    seen.add((g.kind, g.R, g.m, g.W, g.min_blocks, carries_of(g)))
                    for w in (want, scores_only(want)):
                        err = max(err, dp_vs_plain(hs, ops[5], ops[6], series, mode, w,
                                                   f"{mode} {series} B{B}x{bx}x{by}", g))
                del hs, want
        say("dp=plain", shape=f"B{B}x{bx}x{by}", modes=",".join(MODES),
            series="|".join(",".join(map(str, g)) for g in DP_SERIES), traceback="both",
            geometries="throughput(min_blocks=4,5),latency(R=3,R=tiles)",
            default_geometry=repr(wavefront.dp_geometry(B, bx + 1, 2, False)),
            default_geometry_traceback=repr(wavefront.dp_geometry(B, bx + 1, 2, True)),
            result="bit-equal(all outputs, all tb bytes; NaN-poisoned)")
    lx = torch.tensor([a for a, _ in DP_EDGES], dtype=torch.int32, device=dev)
    ly = torch.tensor([b for _, b in DP_EDGES], dtype=torch.int32, device=dev)
    B, L = len(DP_EDGES), HEADLINE_BUCKET
    hs = torch.from_numpy(rng.normal(0.0, 4.0, size=(2 * L + 1, B, L + 1)).astype(np.float32)).to(dev)
    for mode in MODES:
        for series in DP_SERIES[:2]:
            want = plain_dp(hs, lx, ly, series, mode, True)
            for g in (wavefront.geometry("throughput", L + 1, len(series)),
                      wavefront.geometry("latency", L + 1, len(series), ctas=3),
                      wavefront.geometry("latency", L + 1, len(series))):
                for w in (want, scores_only(want)):
                    err = max(err, dp_vs_plain(hs, lx, ly, series, mode, w, f"edges {mode}", g))
    say("dp=plain-edges", bucket=L, lx_ly=";".join(f"{a},{b}" for a, b in DP_EDGES),
        modes=",".join(MODES), series="11,1|13,7,1", geometries="throughput,latency(R=3,R=8)",
        result="bit-equal(all outputs, all tb bytes; NaN-poisoned)")
    occupancy = {}
    for k in (1, 2, 3, 15):
        for g in (wavefront.geometry("throughput", 1024, k),
                  wavefront.geometry("throughput", 1024, k, min_blocks=5),
                  wavefront.geometry("latency", 1024, k, ctas=2),
                  wavefront.geometry("latency", 1024, k), wavefront.geometry("latency", 2048, k)):
            got = build.load_library().praline_wavefront_dp_smem(g.W, g.T, g.m, k)
            if got != g.smem_bytes:
                raise AssertionError(f"dp smem {g} k={k}: kernel {got} B")
            occupancy[f"k{k}_{g.kind}_R{g.R}_m{g.m}_W{g.W}_n{g.min_blocks}_"
                      f"{carries_of(g)}_{g.smem_bytes}B"] = \
                wavefront.max_active_clusters(k, g)
    say("dp-occupancy", **occupancy)
    say("dp=plain-done", checked=";".join(",".join(map(str, g)) for g in sorted(seen)),
        seconds=round(time.perf_counter() - t0, 3))
    return {"err": err, "occupancy": occupancy, "geometries": sorted(seen)}


def carries_of(g) -> str:
    """Where geometry ``g`` keeps a tile's carries between visits."""
    return "L2" if g.carry_scratch else "registers"


def phase_dp_times(dev) -> dict:
    """K2 at DP_TIMES on the default geometry, in turns with the tiled
    kernel (K6) over the same hs and, where the package has them, the
    DP_VARIANTS geometries; the headline chunk's 64 first problems held
    against the plain DP.  Where the package has it, one more launch counts
    the lane slots the kernel runs (``slots=``), which must equal the model
    ``wavefront.lane_slots``.  Runs on whichever package is imported, so
    that ``python3 chip_smoke.py dp-times DIR`` times another tree's kernels
    (the parent's whole-row DP) at the same shapes in the same call."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels import wavefront
    from praline_tpu_torch.kernels.fused_scores import fused_skewed_scores
    from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
    from praline_tpu_torch.kernels.tiled_dp import wavefront_dp_tiled

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    variants = hasattr(wavefront, "dp_geometry")
    results = {}
    for B, bx, lo, tb in DP_TIMES:
        t0 = time.perf_counter()
        ops = stacked_operands(np.random.default_rng(SEED + 12), dev, s, B, bx, bx, lo)
        hs = fused_skewed_scores(*ops[:5], tier=producer_tier(ops))
        lx, ly = ops[5], ops[6]
        del ops
        args = (lx, ly, (11, 1), "global", tb)
        d = {"dp_ms": cuda_ms(lambda: wavefront.wavefront_dp(hs, *args), 5),
             "tiled_ms": cuda_ms(lambda: wavefront_dp_tiled(hs, *args), 5)}
        if variants:
            g = wavefront.dp_geometry(B, bx + 1, 2, tb)
            d["geometry"] = f"{g.kind}:R{g.R}:m{g.m}:W{g.W}:n{g.min_blocks}:{carries_of(g)}"
            ran = torch.zeros(1, dtype=torch.int64, device=dev)
            wavefront.wavefront_dp(hs, *args, slots=ran)
            model = wavefront.lane_slots(lx.cpu().numpy(), ly.cpu().numpy(), hs.shape[0], bx + 1,
                                         g, tb)
            if ran.item() != model:
                raise AssertionError(f"dp-times B{B}x{bx}: the kernel ran {ran.item()} lane "
                                     f"slots, lane_slots says {model}")
            d["lane_slots_per_cell"] = ran.item() / needed_cells(lx, ly)
            for kind, ctas, n in DP_VARIANTS:
                v = wavefront.geometry(kind, bx + 1, 2, ctas=ctas, min_blocks=n)
                name = f"{kind}_R{v.R}_m{v.m}_n{n}_{carries_of(v)}_ms"
                d[name] = cuda_ms(lambda: wavefront.wavefront_dp(hs, *args, geometry=v), 5)
        d["dp_again_ms"] = cuda_ms(lambda: wavefront.wavefront_dp(hs, *args), 5)
        d["wall_s"] = time.perf_counter() - t0
        d.update(dp_bound(lx, ly, wavefront.wavefront_dp(hs, *args)))
        if B > 64:
            sub = hs[:, :64].contiguous()
            got = wavefront.wavefront_dp(sub, lx[:64].contiguous(), ly[:64].contiguous(),
                                         (11, 1), "global", tb)
            same_outputs(got, plain_dp(sub, lx[:64], ly[:64], (11, 1), "global", tb),
                         f"dp-times B{B}x{bx} first 64")
            del sub
        tag = f"B{B}x{bx}x{bx}_{'traceback' if tb else 'scores'}"
        results[tag] = d
        say("dp-times", shape=tag, **{k: (round(v, 4) if isinstance(v, float) else v)
                                      for k, v in d.items()})
        del hs
        torch.cuda.empty_cache()
    return results


def phase_goldens(dev):
    """The 8 goldens byte-equal through the fused route (knob 1), then
    through the two-kernel route (knob 0)."""
    from praline_tpu_torch import (
        ALPHABET_AA, ALPHABET_DNA, PralineConfig, builtin_score_matrix,
        format_alignment_clustal, format_alignment_fasta, load_sequence_fasta, msa_align,
    )
    from praline_tpu_torch import METRICS
    from praline_tpu_torch.kernels import fused_dp, fused_scores, replay, wavefront

    td = ROOT / "testdata"
    walks = {}
    for knob in ("1", "0"):
        before = (sum(fused_dp.launches.values()), sum(fused_scores.launches.values()),
                  wavefront.launches, replay.launches)
        t0 = time.perf_counter()
        with route_knob(knob):
            for family, tag, mname, kw in GOLDENS:
                alphabet = ALPHABET_DNA if family == "dna8" else ALPHABET_AA
                seqs = load_sequence_fasta(td / f"{family}.fasta", alphabet)
                aln = msa_align(seqs, builtin_score_matrix(mname), PralineConfig(**kw), device=dev)
                walks[f"{family}.{tag}"] = (f"{METRICS.notes['merge_walk']}"
                                            f":{METRICS.notes.get('merge_rung', '-')}")
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
        # PAM250 fails the device merge's exactness guard, as in the JAX package
        if walks["family16div.pam250_semi_pplocal"] != "per-level:-":
            raise AssertionError(f"the PAM250 golden took the {walks['family16div.pam250_semi_pplocal']} "
                                 "merge walk")
        say("goldens", route="fused" if knob == "1" else "two_kernel", cases=len(GOLDENS),
            result="byte-equal", merge_walks=",".join(f"{k}={v}" for k, v in walks.items()),
            seconds=round(time.perf_counter() - t0, 3))


def compose_table(rng, dev, J, C, A):
    """A node table of 3J slots on the card: slots 0 .. 2J - 1 random integer
    profiles of C/4 to C/2 columns (the last join's C/2 to C, so that its
    merged profile may outgrow C; a fifth of the columns with a residue of
    300-499 counts, so that merged columns cross COUNT_LIMIT), gap counts
    and 1-400 members; slots 2J .. 3J - 1 the joins' outputs.  Returns the
    table, the inverse table and the host counts, gaps and member counts."""
    import numpy as np
    import torch

    from praline_tpu_torch.kernels import compose

    M = 3 * J
    lens = rng.integers(max(1, C // 4), C // 2 + 1, size=2 * J)
    lens[-2:] = rng.integers(C // 2, C + 1, size=2)
    counts = np.zeros((M, C, A), np.float32)
    gaps = np.zeros((M, C), np.float32)
    for k, L in enumerate(lens):
        c = rng.integers(0, 3, size=(L, A)).astype(np.float32)
        big = rng.random(L) < 0.2
        c[big, rng.integers(0, A, size=int(big.sum()))] += rng.integers(300, 500, size=int(big.sum()))
        counts[k, :L] = c
        gaps[k, :L] = rng.integers(0, 60, size=L)
    mems = np.r_[rng.integers(1, 401, size=2 * J), np.zeros(J)].astype(np.int32)
    inv_table = compose.inverse_table(float(counts.sum(-1).max()))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    table = compose.NodeTable(up(counts), up(gaps), up(compose.column_inverses(counts, inv_table)),
                              up(np.r_[lens, np.ones(J)].astype(np.int32)), up(mems))
    return table, up(inv_table), counts, gaps, mems


def clone_table(table):
    from praline_tpu_torch.kernels.compose import NodeTable

    return NodeTable(*(getattr(table, f.name).clone() for f in dataclasses.fields(table)))


def over_limit_columns(tape, nmv, counts, gaps, mems, li, ri, C) -> int:
    """Merged columns whose counts plus gaps exceed COUNT_LIMIT before the
    rescale, from the host copies of the tapes and the children (joins
    within the capacity C)."""
    import numpy as np

    over = 0
    for j in (j for j in range(len(nmv)) if nmv[j] <= C):
        m = tape[j, : nmv[j]][::-1]
        tx, ty = (m == 1) | (m == 2), (m == 1) | (m == 3)
        side = lambda s, take, other: np.where(
            take, (counts[s].sum(-1) + gaps[s])[np.clip(np.cumsum(take) - 1, 0, None)], other)
        over += int((side(li[j], tx, mems[li[j]]) + side(ri[j], ty, mems[ri[j]]) > 992).sum())
    return over


def compose_shapes(msa_seqs, long_seqs, long8_seqs):
    """(J, C) of the compose checks: a merge level at the headline bucket
    1023 and at msa128's first rung, one of 16 joins at long32's (the fused
    kernel's) and one of 1 and of 4 joins at long8's (the tiled kernel's),
    the widest levels those walks run."""
    from praline_tpu_torch.msa.device_merge import ladder

    rung = lambda seqs: ladder(max(q.length for q in seqs))[0]
    return ((32, HEADLINE_BUCKET), (32, rung(msa_seqs)), (16, rung(long_seqs)),
            (1, rung(long8_seqs)), (4, rung(long8_seqs)))


def phase_compose(dev, shapes):
    """The compose kernel bit for bit against ``compose_plain`` on the card,
    each output slot, tape and length NaN- (or -7, or 0xAB-) poisoned first,
    in the three modes at ``shapes`` (J joins at capacity C): tapes from the
    DP's traceback and walk at (C, C) on the route of kernels/batch.py, and in
    semiglobal and local mode hand-made ones in the first three rows (an
    empty local walk, a walk of x moves alone, one of y moves alone), over
    columns that cross COUNT_LIMIT.  Then the kernel's and the plain
    version's times at the second shape, with its bound in bytes (the two
    children's needed columns and the tapes read, the output slot and the
    full tapes written)."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels import batch, compose
    from praline_tpu_torch.kernels.fused_scores import tier_of

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    A = s.shape[0]
    rng = np.random.default_rng(SEED + 16)
    t0, err, over, outgrown, out = time.perf_counter(), 0.0, 0, 0, {}
    for J, C in shapes:
        for mode in MODES:
            table, inv_dev, counts, gaps, mems = compose_table(rng, dev, J, C, A)
            li = torch.arange(0, 2 * J, 2, dtype=torch.int32, device=dev)
            ri, oi = li + 1, torch.arange(2 * J, 3 * J, dtype=torch.int32, device=dev)
            ops = (table.counts[li.long()], table.inv[li.long()], table.counts[ri.long()],
                   table.inv[ri.long()])
            route = batch.choose_route("cuda", C, C, True)
            tier = tier_of(counts[0::2][:J], counts[1::2][:J], s.cpu().numpy())
            walk = batch.dispatch(route, *ops, s, table.lens[li.long()], table.lens[ri.long()],
                                  gap_series=(11, 1), mode=mode, traceback=True,
                                  tier=tier if batch.takes_tier(route, C, C, dev) else None)
            moves, nm, ti, tj = walk["moves"], walk["nmoves"], walk["ti"], walk["tj"]
            lens = table.lens.cpu().numpy()
            if mode != "global" and J >= 3:
                # an empty local walk (or a semiglobal one of x moves), x alone, y alone
                for row, kind in enumerate(("empty", "x", "y")):
                    k = 0 if kind == "empty" and mode == "local" else \
                        min(40, lens[2 * row + (kind == "y")])
                    moves[row].zero_()
                    moves[row, :k] = 3 if kind == "y" else 2
                    nm[row] = k
                    ti[row] = 0 if kind == "y" else k
                    tj[row] = k if kind == "y" else 0
            want = clone_table(table)
            tape_p, nmv_p = compose.compose_plain(moves, nm, ti, tj, want, li, ri, oi, inv_dev, mode)
            got = clone_table(table)
            for t in (got.counts, got.gaps, got.inv):
                t[oi.long()] = float("nan")
            got.lens[oi.long()] = -7
            got.mems[oi.long()] = -7
            tape_k = torch.full_like(tape_p, 0xAB)
            nmv_k = torch.full_like(nmv_p, -7)
            before = compose.launches
            compose.compose(moves, nm, ti, tj, got, li, ri, oi, inv_dev, mode, tape_out=tape_k,
                            nmv_out=nmv_k)
            if compose.launches != before + 1:
                raise AssertionError("compose: no launch counted")
            for key, a, b in (("tape", tape_k, tape_p), ("nmv", nmv_k, nmv_p),
                              ("counts", got.counts, want.counts), ("gaps", got.gaps, want.gaps),
                              ("inv", got.inv, want.inv), ("lens", got.lens, want.lens),
                              ("mems", got.mems, want.mems)):
                torch.cuda.synchronize()
                if a.dtype == torch.float32:
                    err = max(err, bit_equal(a, b, f"compose {key} {mode} J{J} C{C}"))
                elif not torch.equal(a, b):
                    raise AssertionError(f"compose {key} {mode} J{J} C{C} differs from plain")
            outgrown += int((nmv_p > C).sum())
            over += over_limit_columns(tape_p.cpu().numpy(), nmv_p.cpu().numpy(), counts, gaps,
                                       mems, li.cpu().numpy(), ri.cpu().numpy(), C)
            if (J, C) == shapes[1] and mode == "global":
                args = (moves, nm, ti, tj, got, li, ri, oi, inv_dev, mode)
                ms = cuda_ms(lambda: compose.compose(*args, tape_out=tape_k, nmv_out=nmv_k), 10)
                plain_ms = cuda_ms(lambda: compose.compose_plain(*args[:4], want, *args[5:]), 3)
                needed = float(lens[0:2 * J].sum()) * (A + 1) * 4 + float(nm.sum())
                written = J * C * (A + 2) * 4 + tape_k.numel() + J * 3 * 4
                out = {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "shape": f"J{J}xC{C}",
                       "again_ms": cuda_ms(lambda: compose.compose(*args, tape_out=tape_k,
                                                                   nmv_out=nmv_k), 10),
                       **bound(needed + written, 0.0)}
            del walk, moves, want, got
    if not over:
        raise AssertionError("compose: no merged column crossed COUNT_LIMIT")
    out["err"] = err
    say("compose=plain", shapes="|".join(f"J{J}xC{C}" for J, C in shapes), modes=",".join(MODES),
        tapes="DP traceback + empty local walk, x alone, y alone", over_limit_columns=over,
        joins_past_capacity=outgrown,
        result="bit-equal(tapes, lengths, table slots; poisoned)",
        seconds=round(time.perf_counter() - t0, 3),
        **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in out.items()})
    return out


def merge_inputs(dev, seqs):
    """The merge stage's inputs as ``msa_align`` makes them with the default
    config: the preprofiled members and the guide tree."""
    from praline_tpu_torch import PralineConfig, builtin_score_matrix
    from praline_tpu_torch.msa.pipeline import batched_all_pairs, batched_preprofiles
    from praline_tpu_torch.oracle.tree import build_guide_tree, similarity_from_scores

    cfg = PralineConfig()
    matrix = builtin_score_matrix("blosum62")
    pp = batched_preprofiles(seqs, matrix, cfg, device=dev)
    scores, lengths = batched_all_pairs(pp, matrix, cfg, device=dev)
    tree = build_guide_tree(similarity_from_scores(scores, lengths, cfg.score_normalization),
                            cfg.linkage)
    return pp, tree, matrix, cfg


def tier_runs(tiers) -> str:
    """Each level's tier, run-length encoded: ``mma*70,scalar*2``."""
    runs = []
    for t in tiers:
        if runs and runs[-1][0] == t:
            runs[-1][1] += 1
        else:
            runs.append([t, 1])
    return ",".join(f"{t}*{n}" for t, n in runs)


def phase_device_merge(dev, name, seqs, ladders=()):
    """The device walk of ``name``'s merge stage: each attempt enqueued
    under ``torch.cuda.set_sync_debug_mode("error")`` (any call that
    synchronizes raises), then the one host copy; its rung, attempts, route
    and each level's tier; then the device walk and the per-level path on
    the same tree, :data:`MERGE_TURNS` times each in alternating order
    (device first, then per-level first), each byte-equal to the first
    walk.  ``ladders``: (label, rungs) walks timed twice each, byte-equal
    too."""
    import torch

    from praline_tpu_torch import format_alignment_fasta
    from praline_tpu_torch.msa.device_merge import (
        collect_walk, enqueue_walk, merge_on_device, plan_merge, try_device_merge,
    )
    from praline_tpu_torch.msa.pipeline import per_level_merge

    t0 = time.perf_counter()
    pp, tree, matrix, cfg = merge_inputs(dev, seqs)
    plan = plan_merge(pp, tree, matrix, cfg)
    if plan is None:
        raise AssertionError(f"{name}: the device merge refused the family")
    attempts, aln, walk = [], None, None
    t_walk = time.perf_counter()
    enqueue_s = 0.0
    for C in plan.rungs:
        attempts.append(C)
        torch.cuda.set_sync_debug_mode("error")
        try:
            t1 = time.perf_counter()
            walk = enqueue_walk(plan, C, dev)
            enqueue_s += time.perf_counter() - t1
        finally:
            torch.cuda.set_sync_debug_mode("default")
        aln = collect_walk(plan, walk)
        if aln is not None:
            break
    walk_s = time.perf_counter() - t_walk
    if aln is None:
        raise AssertionError(f"{name}: every rung of {plan.rungs} overflowed")
    text = format_alignment_fasta(aln)

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t1

    _, collect_idle_s = timed(lambda: collect_walk(plan, walk))  # the copy and gap injection alone
    walks = {"device": (lambda: try_device_merge(pp, tree, matrix, cfg, device=dev), []),
             "per_level": (lambda: per_level_merge(pp, tree, matrix, cfg, device=dev), [])}
    for turn in range(MERGE_TURNS):
        for key in ("device", "per_level")[:: 1 if turn % 2 == 0 else -1]:
            fn, walls = walks[key]
            got, wall = timed(fn)
            if got is None or format_alignment_fasta(got) != text:
                raise AssertionError(f"{name}: the {key} walk's bytes differ from the first "
                                     "device walk's")
            walls.append(wall)
    device_s, per_level_s = walks["device"][1], walks["per_level"][1]
    extra = {}
    for label, rungs in ladders:
        walls = []
        for _ in range(2):
            got, wall = timed(lambda: merge_on_device(dataclasses.replace(plan, rungs=rungs),
                                                      dev))
            if got is None or format_alignment_fasta(got) != text:
                raise AssertionError(f"{name}: ladder {label} {rungs} differs")
            walls.append(wall)
        extra[f"ladder_{label}_rungs"] = "/".join(map(str, rungs))
        extra[f"ladder_{label}_s"] = ",".join(f"{w:.4f}" for w in walls)
    say("device-merge", family=name, walk="device", rung=walk.C_cap,
        attempts="/".join(map(str, attempts)), ladder="/".join(map(str, plan.rungs)),
        route=walk.route, columns=aln.num_columns, levels=len(plan.levels),
        joins=len(tree.joins), tiers=tier_runs(plan.tiers),
        sync_debug="error while enqueued", enqueue_s=round(enqueue_s, 4),
        first_walk_s=round(walk_s, 4), collect_on_idle_device_s=round(collect_idle_s, 4),
        turns="device,per_level then per_level,device, in turn",
        device_walk_s=",".join(f"{w:.4f}" for w in device_s),
        per_level_s=",".join(f"{w:.4f}" for w in per_level_s),
        median_device_walk_s=round(statistics.median(device_s), 4),
        median_per_level_s=round(statistics.median(per_level_s), 4),
        device_faster_turns=sum(d < p for d, p in zip(device_s, per_level_s)),
        result="byte-equal to the per-level path",
        seconds=round(time.perf_counter() - t0, 3), **extra)


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
        notes = dict(METRICS.notes)
        if notes.get("merge_walk") != "device":
            raise AssertionError(f"{name}: the merge took the {notes.get('merge_walk')} walk")
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
            **{f"{k}_s": v["seconds"] for k, v in stages.items()},
            merge_walk=notes["merge_walk"], merge_rung=notes["merge_rung"],
            merge_attempts="/".join(map(str, notes["merge_attempts"])),
            merge_route=notes["merge_route"])
    if texts[0] != texts[1]:
        raise AssertionError(f"{name}: two runs gave different bytes")
    return lambda: msa_align(seqs, matrix, PralineConfig(), device=dev)


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


# ---- the long routes: checkpointed traceback, in-place composites ----

# (a) the new launches against the full traceback and their plain versions
LONG_CHECK = (2, 3000, 2800, 2500)  # B, bx, by, shortest member
LONG_CHECK_MODES = ("global", "local")
TITIN_LENGTH = 34_350  # titin's canonical isoform, aa
DNA_UNDER = 72_000  # nt: full traceback just under the scaled budget (2 bytes a cell)
DNA_PAST = 75_000  # nt: past it, so checkpointed unforced
TITIN_FAMILY = 4
TRACKS_LONG = 26_000  # residues a side: a two-track composite past the scaled hs budget
FORCED_TB_BUDGET = 1 << 24  # lowered in this process to force the checkpointed route
# (gap series, geometry, carries in the scratch) of the checks at several
# tiles a CTA, as the main paths run (titin m = 5, carries in shared
# memory; the 75,000-nt pair m = 10, carries in the device-memory scratch):
# m = 6 at LONG_CHECK's 3001 lanes
LONG_MANY_TILES = (((11, 1), dict(ctas=2, tile_lanes=256), False),
                   ((13, 7, 1), dict(ctas=1, tile_lanes=512), True))


def mutated(rng, root, alphabet_size, indels=20):
    """``root`` with 25% substitutions and ``indels`` short insertions or
    deletions (1-3 residues each, half of each)."""
    import numpy as np

    toks = root.copy()
    sub = rng.random(toks.size) < 0.25
    toks[sub] = rng.integers(0, alphabet_size, size=int(sub.sum()))
    for k in range(indels):
        at, n = int(rng.integers(0, toks.size - 3)), int(rng.integers(1, 4))
        toks = (np.insert(toks, at, rng.integers(0, alphabet_size, size=n)) if k % 2
                else np.delete(toks, np.arange(at, at + n)))
    return toks.astype(np.int32)


def long_pair(seed, length, alphabet):
    """Two seeded relatives of a ``length``-residue root."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = 4 if alphabet.size <= 5 else 20  # residues only (no wildcard)
    root = rng.integers(0, A, size=length)
    return mutated(rng, root, A), mutated(rng, root, A)


@contextlib.contextmanager
def forced_tb_budget():
    """``batch.TB_BYTES_BUDGET`` lowered in this process: every traceback
    past the hs budget or the whole-row lanes runs checkpointed."""
    from praline_tpu_torch.kernels import batch

    kept = batch.TB_BYTES_BUDGET
    batch.TB_BYTES_BUDGET = FORCED_TB_BUDGET
    try:
        yield
    finally:
        batch.TB_BYTES_BUDGET = kept


def cells_in_block(lx, ly, d0, d1) -> float:
    """Cells 1 <= i <= lx, 1 <= j <= ly with d0 <= i + j <= d1, summed over
    the problems."""
    import numpy as np

    total = 0.0
    for a, b in zip(lx.tolist(), ly.tolist()):
        i = np.arange(1, a + 1)
        lo, hi = np.maximum(d0 - i, 1), np.minimum(d1 - i, b)
        total += float(np.clip(hi - lo + 1, 0, None).sum())
    return total


def checkpointed_vs_full(source, lx, ly, series, mode, R, full, want_moves, want_n, what):
    """The forward launch's terminals, every block's resumed bytes and the
    block walk's tape against the full traceback launch and its walk."""
    import torch

    from praline_tpu_torch.kernels import replay, tiled_dp

    D, B, Lp = full["tb"].shape[0] + 2, full["tb"].shape[1], full["tb"].shape[2]
    out, snap = tiled_dp.wavefront_dp_tiled_forward(source, lx, ly, series, mode, R)
    for key in ("score", "length", "ti", "tj", "tcode"):
        if not torch.equal(out[key], full[key]):
            raise AssertionError(f"{what}: forward {key} differs from the traceback launch")
    state = replay.walk_state(out["ti"], out["tj"], out["tcode"], len(series))
    moves = torch.zeros((B, D - 1), dtype=torch.uint8, device=lx.device)
    block = torch.empty((R, B, Lp), dtype=torch.uint8, device=lx.device)
    for q in range(snap.shape[0] - 1, -1, -1):
        tiled_dp.wavefront_dp_tiled_resume(source, lx, ly, series, mode, R, q, snap, out=block)
        rows = min(R, D - 2 - q * R)
        if not torch.equal(block[:rows], full["tb"][q * R: q * R + rows]):
            raise AssertionError(f"{what}: block {q} of {R} diagonals differs from tb")
        replay.replay_block(block, state, moves, q, series, mode)
    torch.cuda.synchronize()
    if not (torch.equal(moves, want_moves) and torch.equal(state[5], want_n)):
        raise AssertionError(f"{what}: the block walk's tape differs from replay_moves")
    return snap.shape[0]


def plain_checkpointed(hs, lx, ly, series, mode, R):
    """The plain checkpointed traceback over ``hs``: the forward pass's
    terminals and snapshot, every block's bytes, and the block walk's tape
    and move counts over them."""
    import torch

    from praline_tpu_torch.kernels import replay
    from praline_tpu_torch.kernels.scan import forward_snapshots, resume_block

    out, snap = forward_snapshots(hs, lx, ly, series, mode, R)
    blocks = [resume_block(hs, snap, q, R, series, mode) for q in range(snap.shape[0])]
    state = replay.walk_state(out["ti"], out["tj"], out["tcode"], len(series))
    moves = torch.zeros((hs.shape[1], hs.shape[0] - 1), dtype=torch.uint8, device=hs.device)
    for q in range(len(blocks) - 1, -1, -1):
        replay.replay_block_plain(blocks[q], state, moves, q, series, mode)
    return out, snap, blocks, moves, state[5]


def many_tiles_vs_plain(source, lx, ly, series, mode, R, plain, geometry, what):
    """At ``geometry``: the forward launch's terminals and snapshot, every
    block's resumed bytes, the block walk's tape, and the full traceback
    launch's terminals and bytes against :func:`plain_checkpointed`'s."""
    import torch

    from praline_tpu_torch.kernels import replay, tiled_dp

    want_out, want_snap, want_blocks, want_moves, want_n = plain
    out, snap = tiled_dp.wavefront_dp_tiled_forward(source, lx, ly, series, mode, R, **geometry)
    torch.cuda.synchronize()
    for key in want_out:
        if not torch.equal(out[key], want_out[key]):
            raise AssertionError(f"{what}: forward {key} differs from plain")
    if not torch.equal(snap.view(torch.int32), want_snap.view(torch.int32)):
        raise AssertionError(f"{what}: the snapshot differs from plain")
    state = replay.walk_state(out["ti"], out["tj"], out["tcode"], len(series))
    moves = torch.zeros_like(want_moves)
    block = torch.empty_like(want_blocks[0])
    for q in range(snap.shape[0] - 1, -1, -1):
        tiled_dp.wavefront_dp_tiled_resume(source, lx, ly, series, mode, R, q, snap, out=block,
                                           **geometry)
        rows = min(R, want_moves.shape[1] - 1 - q * R)  # rows past D - 1 are not written
        if not torch.equal(block[:rows], want_blocks[q][:rows]):
            raise AssertionError(f"{what}: block {q} differs from plain")
        replay.replay_block(block, state, moves, q, series, mode)
    torch.cuda.synchronize()
    if not (torch.equal(moves, want_moves) and torch.equal(state[5], want_n)):
        raise AssertionError(f"{what}: the block walk's tape differs from plain")
    full = tiled_dp.wavefront_dp_tiled(source, lx, ly, series, mode, True, **geometry)
    rows = full["tb"].shape[0]
    want_tb = torch.cat(want_blocks)[:rows]
    same_outputs(full, {**want_out, "tb": want_tb}, f"{what}: the traceback launch")


def phase_long_kernels(dev) -> dict:
    """The checkpointed launches at B2 x 3000 x 2800: in global and local
    modes on both sources, at R = the default and 64, the forward launch's
    terminals equal the traceback launch's, every block's resumed bytes its
    rows of tb (all cells) and the block walk's tapes replay_moves's; the
    forward launch's snapshot and one block's bytes and walk against their
    plain versions, bit for bit; the in-place composite (BLOSUM62 + PAM250,
    weights 1 and 0.5) bit-equal to the tiled kernel over the materialized
    composite hs, and against the plain DP.  Each new launch timed."""
    import numpy as np
    import torch

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels import replay, tiled_dp
    from praline_tpu_torch.kernels.scan import (
        default_ckpt_interval, forward_snapshots, resume_block, wavefront_dp as plain_dp,
    )
    from praline_tpu_torch.kernels.scores import composite_skewed_scores
    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores

    t0 = time.perf_counter()
    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    B, bx, by, lo = LONG_CHECK
    ops = stacked_operands(np.random.default_rng(SEED + 20), dev, s, B, bx, by, lo)
    lx, ly = ops[5], ops[6]
    hs = plain_scores(*ops[:5])
    D, Lp = bx + by + 1, bx + 1
    R0 = default_ckpt_interval(D)
    series = (11, 1)
    blocks = {}
    for mode in LONG_CHECK_MODES:
        full = tiled_dp.wavefront_dp_tiled(hs, lx, ly, series, mode, True)
        want_moves, want_n = replay.replay_moves(full["tb"], full["ti"], full["tj"],
                                                 full["tcode"], series, mode, D - 1)
        for name, source in (("hs", hs), ("rows", ops[:5])):
            for R in (R0, 64):
                blocks[f"{mode}:{name}:R{R}"] = checkpointed_vs_full(
                    source, lx, ly, series, mode, R, full, want_moves, want_n,
                    f"{mode} {name} R={R}")
        del full
    say("long=checkpointed", shape=f"B{B}x{bx}x{by}", modes=",".join(LONG_CHECK_MODES),
        sources="hs,rows", intervals=f"{R0},64", blocks=json.dumps(blocks),
        result="forward terminals = traceback launch; every block's bytes = tb rows (all "
               "cells); block-walk tapes = replay_moves", seconds=round(time.perf_counter() - t0, 3))

    # several tiles a CTA, on both sources and the in-place composite
    # (BLOSUM62 + PAM250, weights 1 and 0.5; local mode), against plain
    t1 = time.perf_counter()
    pam = matrix_to_torch(builtin_score_matrix("pam250"), dev)
    tracks = [ops[:5], (*ops[:4], pam)]  # the same columns under two matrices
    weights = (1.0, 0.5)
    comp = tiled_dp.Composite(*[tuple(t[i] for t in tracks) for i in range(5)], weights)
    comp_hs = composite_skewed_scores(*[[t[i] for t in tracks] for i in range(5)], weights)
    geometries = []
    for series, geometry, scratch in LONG_MANY_TILES:
        for kind in tiled_dp.SOURCES:
            g = tiled_dp.tiled_geometry(Lp, len(series), kind, **geometry)
            if g.m < 2 or g.carry_scratch != scratch:
                raise AssertionError(f"{geometry} on {kind}: {g}, not the geometry checked")
        geometries.append(f"R{g.R}xm{g.m}xW{g.W}:k{len(series)}:"
                          f"{'scratch' if scratch else 'smem'}")
        for mode in LONG_CHECK_MODES:
            cases = [(hs, (("hs", hs), ("rows", ops[:5])))]
            if mode == "local":
                cases.append((comp_hs, (("composite", comp),)))
            for scores, sources in cases:
                plain = plain_checkpointed(scores, lx, ly, series, mode, R0)
                for name, source in sources:
                    many_tiles_vs_plain(source, lx, ly, series, mode, R0, plain, geometry,
                                        f"{mode} {name} {geometry} k={len(series)}")
                del plain
    say("long=many-tiles", shape=f"B{B}x{bx}x{by}", R=R0, geometries=",".join(geometries),
        modes=",".join(LONG_CHECK_MODES), sources="hs,rows,composite(local)",
        result="forward terminals and snapshot, every block's bytes, the block walk's tape and "
               "the traceback launch (terminals, all bytes) bit-equal to plain",
        seconds=round(time.perf_counter() - t1, 3))

    # against the plain versions (global, rows source, R0), timed
    mode, source = "global", ops[:5]
    plain = []
    plain_fwd_ms = cuda_ms(lambda: plain.append(forward_snapshots(hs, lx, ly, series, mode, R0)),
                           1, warm_up=False)
    want_out, want_snap = plain[0]
    got, snap = tiled_dp.wavefront_dp_tiled_forward(source, lx, ly, series, mode, R0)
    torch.cuda.synchronize()
    if not all(torch.equal(got[k], want_out[k]) for k in want_out) or \
            not torch.equal(snap.view(torch.int32), want_snap.view(torch.int32)):
        raise AssertionError("forward launch: terminals or snapshot differ from plain")
    fwd_ms = cuda_ms(lambda: tiled_dp.wavefront_dp_tiled_forward(source, lx, ly, series, mode,
                                                                 R0), 3)
    q = snap.shape[0] // 2
    d0 = 2 + q * R0
    block = torch.empty((R0, B, Lp), dtype=torch.uint8, device=dev)
    pblock = []
    plain_resume_ms = cuda_ms(lambda: pblock.append(resume_block(hs, snap, q, R0, series, mode)),
                              1, warm_up=False)
    tiled_dp.wavefront_dp_tiled_resume(source, lx, ly, series, mode, R0, q, snap, out=block)
    torch.cuda.synchronize()
    if not torch.equal(block, pblock[0]):
        raise AssertionError(f"resume launch: block {q} differs from plain")
    resume_ms = cuda_ms(lambda: tiled_dp.wavefront_dp_tiled_resume(
        source, lx, ly, series, mode, R0, q, snap, out=block), 5)
    # the block walk from the state where the walks enter block q
    state = replay.walk_state(got["ti"], got["tj"], got["tcode"], len(series))
    moves = torch.zeros((B, D - 1), dtype=torch.uint8, device=dev)
    bits = torch.empty_like(block)
    for p in range(snap.shape[0] - 1, q, -1):
        tiled_dp.wavefront_dp_tiled_resume(source, lx, ly, series, mode, R0, p, snap, out=bits)
        replay.replay_block(bits, state, moves, p, series, mode)
    entry = (state.clone(), moves.clone())
    st_p, mv_p = entry[0].clone(), entry[1].clone()
    plain_walk_ms = cuda_ms(lambda: replay.replay_block_plain(block, st_p, mv_p, q, series, mode),
                            1, warm_up=False)
    replay.replay_block(block, state, moves, q, series, mode)
    torch.cuda.synchronize()
    if not (torch.equal(state, st_p) and torch.equal(moves, mv_p)):
        raise AssertionError(f"block walk: block {q} differs from plain")
    emitted = float((state[5] - entry[0][5]).sum())

    def walk_again():
        state.copy_(entry[0])
        replay.replay_block(block, state, moves, q, series, mode)

    walk_ms = cuda_ms(walk_again, 10)

    # the in-place composite beside the materialized composite hs
    want = tiled_dp.wavefront_dp_tiled(comp_hs, lx, ly, series, "local", True)
    got_c = tiled_dp.wavefront_dp_tiled(comp, lx, ly, series, "local", True)
    same_outputs(got_c, want, "composite source vs the tiled kernel over the composite hs")
    pl = []
    comp_plain_ms = cuda_ms(lambda: pl.append(plain_dp(comp_hs, lx, ly, series, "global")),
                            1, warm_up=False)
    comp_err = same_outputs(tiled_dp.wavefront_dp_tiled(comp, lx, ly, series, "global"), pl[0],
                            "composite source vs the plain DP")
    comp_ms = cuda_ms(lambda: tiled_dp.wavefront_dp_tiled(comp, lx, ly, series, "global"), 3)
    del comp_hs, want, got_c, pl

    # bounds: operands read once, outputs (snapshot, block bytes, tape) written once
    A = s.shape[0]
    cells = needed_cells(lx, ly)
    ops_rows = producer_ops(lx, ly, A, "scalar")[0] + cells * DP_OPS_PER_CELL
    snap_bytes = nbytes(snap)
    fwd_bound = bound(operand_bytes(lx, ly, A) + snap_bytes + 5 * 4 * B, ops_rows)
    blk_cells = cells_in_block(lx, ly, d0, d0 + R0 - 1)
    resume_bound = bound(operand_bytes(lx, ly, A) + snap_bytes / snap.shape[0] + blk_cells,
                         blk_cells * (2 * A + 2 + DP_OPS_PER_CELL))
    walk_bound = bound(2 * emitted + 2 * nbytes(state), 0.0)
    comp_bound = bound(2 * operand_bytes(lx, ly, A) + 5 * 4 * B,
                       2 * producer_ops(lx, ly, A, "scalar")[0] + cells * (2 + DP_OPS_PER_CELL))
    out = {
        "forward": {"ms": fwd_ms, "plain_ms": plain_fwd_ms, **fwd_bound,
                    "shape": f"B{B}x{bx}x{by} global rows R={R0}"},
        "resume": {"ms": resume_ms, "plain_ms": plain_resume_ms, **resume_bound,
                   "shape": f"B{B}x{bx}x{by} global rows R={R0} block {q}"},
        "walk_block": {"ms": walk_ms, "plain_ms": plain_walk_ms, **walk_bound,
                       "shape": f"B{B} block {q} of {R0} diagonals, {int(emitted)} moves"},
        "composite": {"ms": comp_ms, "plain_ms": comp_plain_ms, **comp_bound, "err": comp_err,
                      "shape": f"B{B}x{bx}x{by} two tracks global scores"},
    }
    say("long=plain", shape=f"B{B}x{bx}x{by}", R=R0, block=q,
        result="forward (terminals, snapshot), resume and block walk bit-equal to plain; "
               "composite source = tiled over the composite hs (local traceback, all bytes) "
               "= plain DP (global scores)",
        **{f"{k}_{m}": round(v[m], 4) for k, v in out.items()
           for m in ("ms", "plain_ms", "bound_ms")},
        seconds=round(time.perf_counter() - t0, 3))
    return out


def stack_pair(dev, x, y, alphabet):
    """One pair of sequences as the batch aligner's gathered operands at
    their stepped buckets."""
    from praline_tpu_torch import Profile
    from praline_tpu_torch.convert import profiles_to_stack
    from praline_tpu_torch.kernels import batch

    px, py = Profile.from_tokens(x, alphabet), Profile.from_tokens(y, alphabet)
    buckets = (63, 127, 255, 511, 1023, 2047)
    bx, by = batch._bucket(px.length, buckets), batch._bucket(py.length, buckets)
    cx, ivx, lx = profiles_to_stack([px], bx, dev)
    cy, ivy, ly = profiles_to_stack([py], by, dev)
    return cx, ivx, cy, ivy, lx, ly


def timed_peak(fn):
    """``fn()``'s result, its seconds (to a synchronize) and the peak of
    ``torch.cuda.max_memory_allocated`` during it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_titin_pair(dev) -> dict:
    """A seeded titin-length pair (34,350 aa root, 25% substitutions, short
    indels), BLOSUM62, (11, 1), global: the full traceback on the tiled
    route (within the scaled budget), then checkpointed (the budget lowered
    in this process), enqueued with no host sync; score, terminal and tape
    byte-equal, each timed with its peak memory."""
    import torch

    from praline_tpu_torch import ALPHABET_AA, builtin_score_matrix
    from praline_tpu_torch.convert import matrix_to_torch
    from praline_tpu_torch.kernels import batch

    x, y = long_pair(SEED + 22, TITIN_LENGTH, ALPHABET_AA)
    cx, ivx, cy, ivy, lx, ly = stack_pair(dev, x, y, ALPHABET_AA)
    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    bx, by = cx.shape[1], cy.shape[1]
    kw = dict(gap_series=(11, 1), mode="global", traceback=True, tier=None)
    route = batch.choose_route(dev, bx, by, True)
    if route != "tiled" or batch.tiled_source(bx, by, dev) != "rows":
        raise AssertionError(f"titin {bx}x{by}: route {route}, not the tiled rows source")
    full, full_s, full_peak = timed_peak(
        lambda: batch.dispatch(route, cx, ivx, cy, ivy, s, lx, ly, **kw))
    with forced_tb_budget():
        if batch.choose_route(dev, bx, by, True) != "checkpointed":
            raise AssertionError("titin: the lowered budget did not take the checkpointed route")

        def enqueue():
            with torch.cuda.device(dev):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return batch.dispatch("checkpointed", cx, ivx, cy, ivy, s, lx, ly, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")

        ckpt, ckpt_s, ckpt_peak = timed_peak(enqueue)
    n = int(full["nmoves"][0])
    for key in ("score", "length", "ti", "tj", "tcode", "nmoves"):
        if not torch.equal(full[key], ckpt[key]):
            raise AssertionError(f"titin: checkpointed {key} differs from the full traceback")
    if not torch.equal(full["moves"][:, :n], ckpt["moves"][:, :n]) or ckpt["moves"][:, n:].any():
        raise AssertionError("titin: the checkpointed tape differs from the full traceback's")
    out = {"lengths": f"{len(x)}x{len(y)}", "bucket": f"{bx}x{by}", "full_s": full_s,
           "full_peak_bytes": full_peak, "checkpointed_s": ckpt_s,
           "checkpointed_peak_bytes": ckpt_peak, "moves": n,
           "score": float(full["score"][0])}
    say("long=titin", **out, result="score, terminal and tape byte-equal; the checkpointed "
        "route enqueued under sync_debug_mode('error')")
    return out


def run_dna_long(dev) -> dict:
    """Two seeded DNA pairs through ``align_pairs_batched`` with traceback,
    nothing forced: about 72,000 nt, whose full traceback fits the scaled
    budget, and about 75,000 nt, past it (checkpointed).  Each alignment
    degaps to its inputs; the 75,000-nt score equals the scores-only run's.
    Route, time and peak memory of each."""
    import numpy as np

    from praline_tpu_torch import ALPHABET_DNA, GAP, Profile, builtin_score_matrix
    from praline_tpu_torch.kernels import batch

    m = builtin_score_matrix("dna_simple")
    out = {}
    for name, length, want_route in (("under", DNA_UNDER, "tiled"),
                                     ("past", DNA_PAST, "checkpointed")):
        x, y = long_pair(SEED + 23 + length, length, ALPHABET_DNA)
        pairs = [(Profile.from_tokens(x, ALPHABET_DNA), Profile.from_tokens(y, ALPHABET_DNA))]
        batch.reset_route_counts()
        res, secs, peak = timed_peak(lambda: batch.align_pairs_batched(
            pairs, m, (11, 1), "global", device=dev, traceback=True))
        route = "checkpointed" if batch.checkpointed_chunks else \
            ",".join(k for k, v in batch.route_counts.items() if v)
        if route != want_route:
            raise AssertionError(f"dna {length}: took {route}, not {want_route}")
        r = res[0]
        for cols, toks in ((r.cols_x, x), (r.cols_y, y)):
            if not np.array_equal(cols[cols != GAP], np.arange(toks.size)):
                raise AssertionError(f"dna {length}: the alignment does not degap to its input")
        entry = {"lengths": f"{len(x)}x{len(y)}", "route": route, "s": secs,
                 "peak_bytes": peak, "score": r.score, "columns": int(r.cols_x.size)}
        if name == "past":
            scores = batch.align_pairs_batched(pairs, m, (11, 1), "global", device=dev)
            if scores[0].score != r.score:
                raise AssertionError("dna past the budget: score differs from the scores-only run")
            entry["scores_only"] = "equal"
        out[name] = entry
        say("long=dna", case=name, **entry)
    return out


def titin_family():
    """4 seeded members of a titin-length root: each merge is a (C, C)
    traceback past LADDER_TOP, so the merge takes the per-level path."""
    return synthetic_family(TITIN_FAMILY, SEED + 24, root_len=TITIN_LENGTH,
                            lo=TITIN_LENGTH - 300, hi=TITIN_LENGTH)


def run_titin_family(dev, seqs) -> dict:
    """``msa_align`` of the titin-length family, unforced and with the
    traceback budget lowered: the same FASTA bytes."""
    from praline_tpu_torch import (
        METRICS, PralineConfig, builtin_score_matrix, format_alignment_fasta, msa_align,
    )
    from praline_tpu_torch.kernels import batch

    m = builtin_score_matrix("blosum62")
    out, texts = {}, []
    for name, ctx in (("unforced", contextlib.nullcontext), ("forced", forced_tb_budget)):
        batch.reset_route_counts()
        with ctx():
            aln, secs, peak = timed_peak(lambda: msa_align(seqs, m, PralineConfig(), device=dev))
        if METRICS.notes.get("merge_walk") != "per-level":
            raise AssertionError(f"titin family: merge took {METRICS.notes.get('merge_walk')}")
        texts.append(format_alignment_fasta(aln))
        out[name] = {"s": secs, "peak_bytes": peak, "columns": aln.num_columns,
                     "routes": dict(batch.route_counts),
                     "checkpointed_chunks": batch.checkpointed_chunks}
        say("long=titin-family", run=name, sequences=len(seqs),
            lengths=f"{min(q.length for q in seqs)}-{max(q.length for q in seqs)}",
            **out[name], merge_walk="per-level")
    if texts[0] != texts[1]:
        raise AssertionError("titin family: the forced checkpointed run's FASTA differs")
    if not out["forced"]["checkpointed_chunks"]:
        raise AssertionError("titin family: the forced run took no checkpointed chunk")
    return out


def run_long_routes(dev, family) -> dict:
    """The long-routes main path: the DNA pairs, then the titin family."""
    return {"dna": run_dna_long(dev), "titin_family": run_titin_family(dev, family)}


def run_tracks_long(dev) -> dict:
    """Two two-track composites of about 26,000 residues a side, whose
    summed hs passes the scaled budget: the in-place composite source with
    full traceback, unforced, then checkpointed on it (budget lowered);
    the same alignments."""
    import numpy as np

    from praline_tpu_torch import ALPHABET_AA, Profile, builtin_score_matrix
    from praline_tpu_torch.kernels import batch

    mats, w = [builtin_score_matrix("blosum62"), builtin_score_matrix("pam250")], (1.0, 0.5)
    pairs = []
    for k in range(2):
        x, y = long_pair(SEED + 25 + k, TRACKS_LONG, ALPHABET_AA)
        pairs.append(tuple(tuple(Profile.from_tokens(t, ALPHABET_AA) for _ in range(2))
                           for t in (x, y)))
    out, results = {}, []
    for name, ctx, want in (("unforced", contextlib.nullcontext, "tiled"),
                            ("forced", forced_tb_budget, "checkpointed")):
        batch.reset_route_counts()
        with ctx():
            res, secs, peak = timed_peak(lambda: batch.align_tracksets_batched(
                pairs, mats, w, (11, 1), "global", device=dev, traceback=True))
        route = "checkpointed" if batch.checkpointed_chunks else \
            ",".join(k for k, v in batch.route_counts.items() if v)
        if route != want:
            raise AssertionError(f"tracks-long {name}: took {route}, not {want}")
        results.append(res)
        out[name] = {"route": route, "s": secs, "peak_bytes": peak}
        say("long=tracks", run=name, pairs=len(pairs), **out[name])
    for a, b in zip(*results):
        if a.score != b.score or not (np.array_equal(a.cols_x, b.cols_x)
                                      and np.array_equal(a.cols_y, b.cols_y)):
            raise AssertionError("tracks-long: the checkpointed composite differs")
    return out


def phase_cli_profile(dev, seqs) -> dict:
    """The CLI on msa128 with ``--profile-dir``: the trace it writes holds
    ``dispatch:`` spans and the kernels' device events."""
    import tempfile

    from praline_tpu_torch.cli.main import main as cli_main
    from praline_tpu_torch.io import format_sequences_fasta

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "in.fasta").write_text(format_sequences_fasta(seqs))
        t0 = time.perf_counter()
        rc = cli_main([str(tmp / "in.fasta"), str(tmp / "out.fasta"), "--device",
                       dev.type, "--profile-dir", str(tmp / "prof")])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli --profile-dir: exit code {rc}")
        traces = list((tmp / "prof").glob("msa_align.*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"cli --profile-dir: {len(traces)} traces")
        data = json.loads(traces[0].read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = [e for e in events if str(e.get("name", "")).startswith("dispatch:")]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            key = short_kernel_name(str(e.get("name", "")))
            kernels[key] = kernels.get(key, 0) + 1
    if not spans:
        raise AssertionError("cli --profile-dir: no dispatch span in the trace")
    out = {"wall_s": wall, "events": len(events), "dispatch_spans": len(spans),
           "kernel_events": sum(kernels.values()) if kernels else "not measured (no device "
                                                                  "events)"}
    kinds = sorted({e["name"].split(":")[1] if e["name"].count(":") > 1 else "two_kernel"
                    for e in spans})
    say("profile-dir", run="msa128 cli", **out, span_kinds=",".join(kinds),
        kernels=json.dumps(sorted(kernels.items(), key=lambda kv: -kv[1])[:8]))
    return out


def long_only(argv) -> int:
    """``long-routes``: the build, the tiled kernel's ordinary launch at
    ``[tiled-long]`` and the long-routes phases alone (a quick check of the
    checkpointed and composite launches)."""
    smi = phase_environment()
    from praline_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    phase_tiled_long(dev, phase_build())
    phase_long_kernels(dev)
    phase_titin_pair(dev)
    (_, c9) = counted("long-routes", lambda: run_long_routes(dev, titin_family()))
    (_, c10) = counted("tracks-long", lambda: run_tracks_long(dev))
    phase_cli_profile(dev, synthetic_family())
    print(smi)
    return 0


# ---- the pair mesh, two ranks on the card and homology-extended preprofiles ----
MESH_TURNS = 4  # alternating turns of the headline unsharded and on a one-card mesh
TWO_RANKS_TIMEOUT_S = 300  # a rank that fails or hangs fails the phase
TWO_RANKS_COLLECTIVE_S = 120  # the process group's timeout: a lone rank raises
HOMOLOGY_EVERY = 4  # every 4th msa128 member gets hits
HOMOLOGY_HITS = 3  # hits a member


def results_digest(results) -> str:
    """sha256 of a batch aligner's results: each pair's score, length and
    terminal cell, or score and traceback columns (to compare runs in two
    processes without shipping the paths)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for r in results:
        if hasattr(r, "cols_x"):
            h.update(np.float64(r.score).tobytes() + r.cols_x.tobytes() + r.cols_y.tobytes())
        else:
            h.update(np.array([r.score, r.length, r.ti, r.tj], np.float64).tobytes())
    return h.hexdigest()


def phase_mesh(dev, matrix, pairs, msa_seqs) -> dict:
    """``[mesh]``: the headline all-pairs through ``make_pair_mesh(1)`` equal
    to the call without a mesh (both one shard of the sharding layer on the
    card), both timed as warm medians in MESH_TURNS alternating turns; msa128 with
    ``mesh_shape=(1,)`` (the per-level merge, sharded) byte-equal to
    msa128 without a mesh (the device merge)."""
    import torch

    from praline_tpu_torch import METRICS, PralineConfig, format_alignment_fasta, msa_align
    from praline_tpu_torch.dist import make_pair_mesh
    from praline_tpu_torch.kernels.batch import ProfileArena, align_pairs_batched

    mesh = make_pair_mesh(1, device=dev.type)
    if mesh.devices != (dev,):
        raise AssertionError(f"make_pair_mesh(1) drives {mesh.devices}, not {dev}")
    arena = ProfileArena(matrix.alphabet.size, (HEADLINE_BUCKET,), dev)

    def run(m):
        out = align_pairs_batched(pairs, matrix, (11, 1), "global", device=dev,
                                  bucket_sizes=(HEADLINE_BUCKET,), batch_pairs=HEADLINE_PAIRS,
                                  arena=arena, mesh=m)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    want = run(None)
    if run(mesh) != want:
        raise AssertionError("mesh: the headline on a one-card mesh differs from the unsharded call")
    walls = {"unsharded": [], "sharded": []}
    for turn in range(MESH_TURNS):
        for key in (("unsharded", "sharded") if turn % 2 == 0 else ("sharded", "unsharded")):
            t0 = time.perf_counter()
            out = run(mesh if key == "sharded" else None)
            walls[key].append(time.perf_counter() - t0)
            if out != want:
                raise AssertionError(f"mesh: a {key} turn differs from the first unsharded run")
    texts, msa_walls = {}, {}
    for key, cfg, walk in (("device-merge", PralineConfig(), "device"),
                           ("mesh1", PralineConfig(mesh_shape=(1,)), "per-level")):
        t0 = time.perf_counter()
        texts[key] = format_alignment_fasta(msa_align(msa_seqs, matrix, cfg, device=dev))
        msa_walls[key] = time.perf_counter() - t0
        if METRICS.notes.get("merge_walk") != walk:
            raise AssertionError(f"mesh: msa128 {key} took the {METRICS.notes.get('merge_walk')} "
                                 "walk")
    if texts["mesh1"] != texts["device-merge"]:
        raise AssertionError("mesh: msa128 on a one-card mesh differs from the device merge")
    med = {k: statistics.median(v) for k, v in walls.items()}
    say("mesh", pairs=len(pairs), bucket=HEADLINE_BUCKET, results="equal to unsharded",
        turns=MESH_TURNS, **{f"{k}_walls_s": ",".join(f"{w:.4f}" for w in v)
                             for k, v in walls.items()},
        **{f"{k}_warm_median_s": round(v, 4) for k, v in med.items()},
        sharded_over_unsharded=round(med["sharded"] / med["unsharded"], 4),
        msa128="byte-equal (mesh1 per-level = device merge)",
        **{f"msa128_{k}_wall_s": round(v, 4) for k, v in msa_walls.items()})
    return {"warm_median_s": med, "walls_s": walls, "msa128_wall_s": msa_walls,
            "msa_text": texts["device-merge"]}


def two_ranks_rank(argv) -> int:
    """``two-ranks-rank RANK PORT DIR DEVICE``: one of the two ranks of
    ``[two-ranks]`` (gloo, both on ``cuda:0``, or on the CPU): msa128 on a mesh across both
    ranks with a checkpoint directory under DIR, long8's all-pairs stage
    and the ``tracks`` pairs scores only and with traceback; digests of the
    results, the wall clocks, each path's launch counts (set to 0 just
    before it and read just after) and the checkpoint files this rank wrote
    go to DIR/rank{RANK}.json."""
    rank, port, out_dir, device = int(argv[0]), int(argv[1]), Path(argv[2]), argv[3]
    sys.path.insert(0, str(ROOT))
    import hashlib

    import torch

    from praline_tpu_torch import PralineConfig, builtin_score_matrix, format_alignment_fasta
    from praline_tpu_torch import msa_align
    from praline_tpu_torch.bench import tracks_workload
    from praline_tpu_torch.dist import initialize_distributed, make_pair_mesh, shutdown_distributed
    from praline_tpu_torch.kernels import batch
    from praline_tpu_torch.msa import batched_all_pairs

    initialize_distributed(f"localhost:{port}", 2, rank, timeout_s=TWO_RANKS_COLLECTIVE_S)
    try:
        mesh = make_pair_mesh(device=device)
        if mesh.shards != 2 or (device == "cuda" and (
                mesh.devices != (torch.device("cuda", 0),) or mesh.sharing != 2)):
            raise AssertionError(f"rank {rank}: mesh {mesh}")
        matrix = builtin_score_matrix("blosum62")
        out = {}
        writes = []
        replace = Path.replace

        def counted_replace(self, target):
            writes.append(str(target))
            return replace(self, target)

        seqs, long8_seqs = synthetic_family(), long8_family()
        sets, _, mats, w = tracks_workload()
        out["launches"] = {}
        Path.replace = counted_replace
        reset_launches()
        t0 = time.perf_counter()
        aln = msa_align(seqs, matrix, PralineConfig(
            mesh_shape=(2,), checkpoint_dir=str(out_dir / "ck")), device=device)
        out["msa128_wall_s"] = time.perf_counter() - t0
        out["launches"]["msa128"] = read_launches()
        Path.replace = replace
        out["msa128"] = hashlib.sha256(format_alignment_fasta(aln).encode()).hexdigest()
        out["writes"] = writes
        batch.reset_route_counts()
        reset_launches()
        t0 = time.perf_counter()
        scores, lengths = batched_all_pairs(long8_seqs, matrix, PralineConfig(),
                                            device=device, mesh=mesh)
        out["long8_wall_s"] = time.perf_counter() - t0
        out["launches"]["long8"] = read_launches()
        out["long8_routes"] = dict(batch.route_counts)
        out["long8"] = hashlib.sha256(scores.tobytes() + lengths.tobytes()).hexdigest()
        reset_launches()
        for traceback in (False, True):
            t0 = time.perf_counter()
            res = batch.align_tracksets_batched(sets[0], mats, w, (11, 1), "global",
                                                device=device, traceback=traceback,
                                                bucket_sizes=(HEADLINE_BUCKET,), mesh=mesh)
            out[f"tracks_{traceback}_wall_s"] = time.perf_counter() - t0
            out[f"tracks_{traceback}"] = results_digest(res)
        out["launches"]["tracks"] = read_launches()
        (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        shutdown_distributed()
    return 0


def phase_two_ranks(dev, msa_text, long8_seqs, tracks_res, tracks_tb) -> dict:
    """``[two-ranks]``: two processes on the one card (gloo, both on
    ``cuda:0``, the kernels built once by this process before they start),
    each running :func:`two_ranks_rank` with a timeout; every rank's exit
    code is checked, both ranks' msa128 byte-equal to the single-process run,
    only rank 0 wrote checkpoint files, long8's all-pairs (tiled route) and
    the ``tracks`` pairs equal to the unsharded results.  Each path's launches,
    both ranks' summed, are checked against PATH_KERNELS (``[launches]``
    lines ``path=two-ranks-...``) and returned under ``launches``."""
    import hashlib
    import shutil
    import socket
    import tempfile

    from praline_tpu_torch import PralineConfig, builtin_score_matrix
    from praline_tpu_torch.msa import batched_all_pairs

    scores, lengths = batched_all_pairs(long8_seqs, builtin_score_matrix("blosum62"),
                                        PralineConfig(), device=dev)
    want = {"msa128": hashlib.sha256(msa_text.encode()).hexdigest(),
            "long8": hashlib.sha256(scores.tobytes() + lengths.tobytes()).hexdigest(),
            "tracks_False": results_digest(tracks_res), "tracks_True": results_digest(tracks_tb)}
    tmp = Path(tempfile.mkdtemp(prefix="praline_two_ranks_"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "two-ranks-rank",
                               str(rank), str(port), str(tmp), dev.type], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TWO_RANKS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"two-ranks: rank {rank} exited {p.returncode}:\n{log[-3000:]}")
    outs = [json.loads((tmp / f"rank{rank}.json").read_text()) for rank in (0, 1)]
    files = sorted(f.name for f in (tmp / "ck").iterdir())
    shutil.rmtree(tmp)
    for rank, out in enumerate(outs):
        for key, digest in want.items():
            if out[key] != digest:
                raise AssertionError(f"two-ranks: rank {rank}'s {key} differs from the "
                                     "single-process run")
        if out["long8_routes"]["tiled"] < 1:
            raise AssertionError(f"two-ranks: rank {rank}'s long8 took {out['long8_routes']}")
    if not outs[0]["writes"] or outs[1]["writes"]:
        raise AssertionError(f"two-ranks: checkpoint writes {len(outs[0]['writes'])} by rank 0, "
                             f"{len(outs[1]['writes'])} by rank 1")
    launches = {}
    for path in ("msa128", "long8", "tracks"):
        counts = {k: sum(o["launches"][path][k] for o in outs) for k in KERNELS}
        check_launches(f"two-ranks-{path}", counts)
        launches[path] = counts
    res = {"wall_s": wall, "msa128_wall_s": [o["msa128_wall_s"] for o in outs],
           "long8_wall_s": [o["long8_wall_s"] for o in outs],
           "tracks_wall_s": [[o["tracks_False_wall_s"], o["tracks_True_wall_s"]] for o in outs]}
    say("two-ranks", ranks=2, device=f"{dev} both", backend="gloo",
        results="msa128, long8 all-pairs, tracks scores and traceback equal to one process",
        checkpoint=",".join(files), writes_rank0=len(outs[0]["writes"]), writes_rank1=0,
        **{k: json.dumps(v) for k, v in res.items()})
    return res | {"launches": launches}


PSIBLAST_STUB = """#!/bin/sh
query=""
while [ $# -gt 0 ]; do
  [ "$1" = "-query" ] && query="$2"
  shift
done
case "$(head -1 "$query")" in
{cases}
esac
exit 0
"""


def phase_homology(dev, seqs) -> dict:
    """``[homology]``: a ``psiblast`` stub on PATH whose hits (HOMOLOGY_HITS
    for every HOMOLOGY_EVERY-th member) are members of a second seeded
    family; the CLI on msa128 with ``--blast-db stub --preprofile global``
    on the card is byte-equal to ``msa_align`` with
    ``find_homologs(FakeBlastFinder(the same hits))``, and the hits change
    the preprofile counts of exactly the members that have them.  The
    operands of the first and the last producer call of the CLI run that
    took the scalar tier are kept (references, no copies) under
    ``scalar_ops`` for :func:`homology_scalar_vs_plain`."""
    import tempfile

    import numpy as np

    from praline_tpu_torch import METRICS, PralineConfig, Sequence, builtin_score_matrix
    from praline_tpu_torch import format_alignment_fasta, msa_align
    from praline_tpu_torch.cli.main import main as cli_main
    from praline_tpu_torch.io import format_sequences_fasta
    from praline_tpu_torch.kernels import batch
    from praline_tpu_torch.msa import (
        FakeBlastFinder, batched_preprofiles, find_homologs, find_homologs_blast,
    )
    from praline_tpu_torch.types import TRACK_ID_PREPROFILE

    others = synthetic_family(len(seqs[::HOMOLOGY_EVERY]) * HOMOLOGY_HITS, SEED + 13,
                              root_len=900, lo=500, hi=900)
    hits = {}
    for k, seq in enumerate(seqs[::HOMOLOGY_EVERY]):
        group = others[k * HOMOLOGY_HITS:(k + 1) * HOMOLOGY_HITS]
        hits[seq.name] = [Sequence(f"hit{k:03d}_{j}", h.tokens, h.alphabet)
                          for j, h in enumerate(group)]
    cases = "\n".join(f'  ">{name}") printf \'%s\\n\' '
                      + " ".join(f"'{h.name}\t{h.text()}'" for h in group) + " ;;"
                      for name, group in hits.items())
    matrix = builtin_score_matrix("blosum62")
    cfg = PralineConfig(preprofile_mode="global")
    path = os.environ["PATH"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        stub = tmp / "psiblast"
        stub.write_text(PSIBLAST_STUB.format(cases=cases))
        stub.chmod(0o755)
        (tmp / "in.fasta").write_text(format_sequences_fasta(seqs))
        os.environ["PATH"] = f"{tmp}{os.pathsep}{path}"
        producer = batch.fused_skewed_scores
        scalar_ops = {}

        def keep_scalar_operands(cx, inv_x, cy, inv_y, s, *, tier, out=None):
            if tier == "scalar":
                ops = (cx, inv_x, cy, inv_y, s)
                scalar_ops.setdefault("first", ops)
                scalar_ops["last"] = ops
            return producer(cx, inv_x, cy, inv_y, s, tier=tier, out=out)

        batch.fused_skewed_scores = keep_scalar_operands
        try:
            t0 = time.perf_counter()
            rc = cli_main([str(tmp / "in.fasta"), str(tmp / "out.fasta"), "--device", dev.type,
                           "--preprofile", "global", "--blast-db", "stub"])
            cli_wall = time.perf_counter() - t0
            batch.fused_skewed_scores = producer
            stages = METRICS.summary()
            cli_text = (tmp / "out.fasta").read_text() if rc == 0 else ""
            t0 = time.perf_counter()
            mapping = find_homologs_blast(seqs, "stub")
            blast_s = time.perf_counter() - t0
        finally:
            batch.fused_skewed_scores = producer
            os.environ["PATH"] = path
    if rc != 0:
        raise AssertionError(f"homology: the CLI exited {rc}")
    fake = find_homologs(seqs, FakeBlastFinder(hits))
    if {i: [(h.name, h.tokens.tobytes()) for h in v] for i, v in mapping.items()} != \
            {i: [(h.name, h.tokens.tobytes()) for h in v] for i, v in fake.items()}:
        raise AssertionError("homology: the stub's hits differ from FakeBlastFinder's")
    want = format_alignment_fasta(msa_align(seqs, matrix, cfg, device=dev, extra_slaves=fake))
    if cli_text != want:
        raise AssertionError("homology: the CLI's --blast-db FASTA differs from msa_align with "
                             "the same hits")
    plain = batched_preprofiles(seqs, matrix, cfg, device=dev)
    extended = batched_preprofiles(seqs, matrix, cfg, device=dev, extra_slaves=fake)
    changed = {i for i, (p, e) in enumerate(zip(plain, extended))
               if not np.array_equal(p.profiles[TRACK_ID_PREPROFILE].counts,
                                     e.profiles[TRACK_ID_PREPROFILE].counts)}
    if changed != set(fake):
        raise AssertionError(f"homology: preprofiles changed for {sorted(changed)[:8]}..., "
                             f"hits for {sorted(fake)[:8]}...")
    res = {"cli_wall_s": cli_wall, "blast_s": blast_s,
           **{f"{k}_s": v["seconds"] for k, v in stages.items()},
           "preprofile_pairs": stages["preprofiles"]["pairs"]}
    say("homology", sequences=len(seqs), members_with_hits=len(fake),
        hits=sum(len(v) for v in fake.values()), hit_lengths=f"{min(len(h.tokens) for h in others)}"
        f"-{max(len(h.tokens) for h in others)}",
        results="CLI --blast-db = msa_align(FakeBlastFinder hits); preprofiles changed for "
                "exactly the members with hits", **{k: round(v, 4) if isinstance(v, float) else v
                                                   for k, v in res.items()})
    return res | {"scalar_ops": scalar_ops}


def homology_scalar_vs_plain(scalar_ops) -> float:
    """The scalar producer (``csrc/scores.cu``) bit for bit against the plain
    version on the operands ``[homology]`` gave it (its first and last
    scalar-tier call, at their merge level's bucket shape), each output
    NaN-poisoned.  The device merge picks a level's tier from host bounds
    on its counts, so the first call may hold counts the predicate would
    admit; the last (the deepest merge) must hold counts past 255 that it
    refuses.  Run after the path's launches are read, so these launches are
    not the path's.  Returns the largest difference (0.0)."""
    import torch

    from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores

    if not scalar_ops:
        raise AssertionError("homology: no producer call took the scalar tier")
    first, last = scalar_ops["first"], scalar_ops["last"]
    calls = [("first", first), ("last", last)] if last is not first else [("only", last)]
    err, shapes, top = 0.0, [], []
    for which, ops in calls:
        cx, _, cy, _, _ = ops
        most = float(torch.maximum(cx.max(), cy.max()))
        if which != "first" and (most <= 255 or producer_tier(ops) != "scalar"):
            raise AssertionError(f"homology: the last scalar call's operands (counts up to "
                                 f"{most}) are ones the tensor-core predicate admits")
        want = plain_scores(*ops)
        what = f"homology's {which} scalar call B{cx.shape[0]}x{cx.shape[1]}x{cy.shape[1]}"
        err = max(err, producer_vs_plain(ops, want, "scalar", what))
        shapes.append(f"{which}:B{cx.shape[0]}x{cx.shape[1]}x{cy.shape[1]}")
        top.append(most)
    say("producer=homology", tier="scalar", calls=",".join(shapes),
        max_count=",".join(f"{m:g}" for m in top), result="bit-equal(NaN-poisoned output)")
    return err


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
           "walk", "compose", "alu_chains", "smem_chain", "write_blocks", "tiled_forward",
           "tiled_resume", "tiled_composite", "walk_block")
# The launches of the long routes, which only the long paths make.
LONG_KERNELS = ("tiled_forward", "tiled_resume", "tiled_composite", "walk_block")
# The kernels each main path must launch, and the only ones of the tiled,
# long-route and scalar-tier kernels it may launch: the all-pairs headline
# on its default route (two-kernel) and forced onto the fused route, the
# three msa_align runs, the composites (the producer at least twice a chunk:
# see main), and the utilization and wprobe configs.  Only long8 and the
# long routes have rows past the fused kernel's lanes.  The three msa_align
# paths merge on the device walk, whose compose kernel writes each level's
# merged profiles; on a mesh across the two ranks the merge is per level
# (no compose).  Every path's profiles but homology's are integer counts the
# tensor-core predicate admits, so their producer and fused launches take
# the "mma" tier.  Homology's preprofiles hold up to 131 counts a column
# (the master, 127 slaves and its hits), so merged nodes pass the 255 a
# count of P2 (``fused_scores.tensor_core_exact``) and take the scalar
# producer, which ``homology_scalar_vs_plain`` holds against the plain
# version on the operands of that run.
PATH_KERNELS = {"all-pairs": ("scores_mma", "dp"), "all-pairs-fused-route": ("fused",),
                "msa128": ("scores_mma", "dp", "walk", "compose"),
                "long-family": ("fused", "walk", "compose"),
                "long8": ("scores_mma", "tiled", "walk", "compose"), "tracks": ("scores_mma", "dp"),
                "tracks-traceback": ("scores_mma", "dp", "walk"),
                "utilization": ("alu_chains", "smem_chain"), "wprobe": ("write_blocks",),
                "long-routes": ("tiled", "walk", "tiled_forward", "tiled_resume", "walk_block"),
                "tracks-long": ("tiled_composite", "walk", "tiled_forward", "tiled_resume",
                                "walk_block"),
                "mesh": ("scores_mma", "dp", "walk", "compose"),
                "homology": ("scores_mma", "scores_scalar", "dp", "walk", "compose"),
                # [two-ranks]: both ranks' launches, summed
                "two-ranks-msa128": ("scores_mma", "dp", "walk"),
                "two-ranks-long8": ("scores_mma", "tiled"),
                "two-ranks-tracks": ("scores_mma", "dp", "walk")}


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from praline_tpu_torch.kernels import (
        compose, fused_dp, fused_scores, probes, replay, tiled_dp, wavefront,
    )

    for m in (wavefront, tiled_dp, replay, compose, fused_dp, fused_scores, probes):
        m.reset_launches()


def read_launches() -> dict:
    """Every kernel wrapper's launch count since :func:`reset_launches`, by
    the names of KERNELS."""
    from praline_tpu_torch.kernels import (
        compose, fused_dp, fused_scores, probes, replay, tiled_dp, wavefront,
    )

    modules = dict(zip(("dp", "tiled", "walk", "compose"), (wavefront, tiled_dp, replay, compose)))
    return ({f"scores_{k}": v for k, v in fused_scores.launches.items()}
            | {"fused": sum(fused_dp.launches.values())}
            | {f"fused_{k}": v for k, v in fused_dp.launches.items()}
            | {k: m.launches for k, m in modules.items()} | probes.launches
            | {"tiled_forward": tiled_dp.forward_launches,
               "tiled_resume": tiled_dp.resume_launches,
               "tiled_composite": tiled_dp.composite_launches,
               "walk_block": replay.block_launches})


def check_launches(name: str, counts: dict) -> None:
    """Print the path's ``[launches]`` line; fail where a kernel of the path
    never launched, or where it launched a tiled, long-route or scalar-tier
    kernel that PATH_KERNELS does not give it."""
    say("launches", path=name, **counts)
    allowed = PATH_KERNELS[name]
    missing = [k for k in allowed if counts[k] < 1]
    if missing:
        raise AssertionError(f"{name}: kernels of the path never launched: {missing}")
    for kernel in ("scores", "fused"):
        if counts[f"{kernel}_scalar"] and f"{kernel}_scalar" not in allowed:
            raise AssertionError(f"{name}: {counts[f'{kernel}_scalar']} of "
                                 f"{counts[f'{kernel}_scalar'] + counts[f'{kernel}_mma']} {kernel} "
                                 "launches left the tensor-core tier")
    if counts["tiled"] and "tiled" not in allowed:
        raise AssertionError(f"{name}: rows of 4096 lanes or fewer took the tiled kernel")
    if any(counts[k] for k in LONG_KERNELS if k not in allowed):
        raise AssertionError(f"{name}: a path within the budgets took a long route")


def counted(name, phase):
    """Run ``phase`` with every launch count set to 0 just before it; return
    its result and the counts read just after."""
    reset_launches()
    result = phase()
    counts = read_launches()
    check_launches(name, counts)
    return result, counts


# K6's ordinary launches at the shapes of ``tiled-times``: (B, Lx, Ly,
# shortest, mode, traceback, source).
TILED_ORDINARY_SHAPES = ((1, 4600, 4400, 4000, "local", True, "hs"),
                         (1, 4600, 4400, 4000, "local", True, "rows"),
                         (1, 9000, 500, 9000, "global", False, "rows"),
                         (32, 2303, 2303, 1800, "global", False, "hs"))


def phase_tiled_ordinary_times(dev) -> dict:
    """K6's ordinary launches (``wavefront_dp_tiled``) at
    TILED_ORDINARY_SHAPES, by CUDA events, the mean of 10 after a warm-up:
    the launches whose code the checkpointed ones must leave as it was."""
    import numpy as np

    from praline_tpu_torch import builtin_score_matrix
    from praline_tpu_torch.bench import count_profiles
    from praline_tpu_torch.convert import matrix_to_torch, profiles_to_stack
    from praline_tpu_torch.kernels.scores import skewed_pair_scores
    from praline_tpu_torch.kernels.tiled_dp import wavefront_dp_tiled

    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    out = {}
    for B, bx, by, lo, mode, traceback, source in TILED_ORDINARY_SHAPES:
        rng = np.random.default_rng(SEED + 8)
        cx, ivx, lx = profiles_to_stack(count_profiles(rng, B, min(lo, bx), bx, 23), bx, dev)
        cy, ivy, ly = profiles_to_stack(count_profiles(rng, B, min(lo, by), by, 23), by, dev)
        ops = (cx, ivx, cy, ivy, s)
        src = skewed_pair_scores(*ops) if source == "hs" else ops
        out[f"{source}_B{B}x{bx}x{by}_{mode}_{'traceback' if traceback else 'scores'}"] = \
            cuda_ms(lambda: wavefront_dp_tiled(src, lx, ly, (11, 1), mode, traceback), 10)
    return out


def tree_only(argv) -> int:
    """``dp-times [DIR]`` or ``tiled-times [DIR]``: the build and the
    [dp-times] phase (K2 and K6 over hs) or K6's ordinary launches
    (phase_tiled_ordinary_times) alone, on the package of the tree at DIR
    (this checkout by default), so that the parent's kernels are timed at
    this tree's shapes in the same call."""
    global ROOT
    if len(argv) > 1:
        ROOT = Path(argv[1]).resolve()
    smi = phase_environment()
    from praline_tpu_torch.device import resolve_device
    from praline_tpu_torch.kernels import build

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    say("build", root=str(ROOT), seconds=round(time.perf_counter() - t0, 3))
    times = phase_dp_times(dev) if argv[0] == "dp-times" else phase_tiled_ordinary_times(dev)
    say(f"{argv[0]}-tree", root=str(ROOT), json=json.dumps(times))
    print(smi)
    return 0


def dist_only() -> int:
    """``dist``: the build and the phases of the pair mesh and homology
    alone (``[mesh]``, ``[homology]``, ``[two-ranks]``, with the msa128,
    long8 and ``tracks`` runs they compare against)."""
    smi = phase_environment()
    from praline_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    os.environ.pop("PRALINE_FUSED_DP", None)
    build_t0 = time.perf_counter()
    from praline_tpu_torch.kernels import build

    build.build()
    build.load_library()
    say("build", seconds=round(time.perf_counter() - build_t0, 3))
    matrix, pairs, _ = headline_pairs()
    msa_seqs = synthetic_family()
    _, track_cells, _, _, tracks_run = tracks_runner(dev)
    tracks_res, _ = run_tracks(tracks_run, track_cells, 1, False)
    tracks_tb, _ = run_tracks(tracks_run, track_cells, 1, True)
    mesh_out, _ = counted("mesh", lambda: phase_mesh(dev, matrix, pairs, msa_seqs))
    homology, _ = counted("homology", lambda: phase_homology(dev, msa_seqs))
    homology_scalar_vs_plain(homology.pop("scalar_ops"))
    phase_two_ranks(dev, mesh_out["msa_text"], long8_family(), tracks_res, tracks_tb)
    print(smi)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["two-ranks-rank"]:
        return two_ranks_rank(sys.argv[2:])
    if sys.argv[1:2] == ["dist"]:
        return dist_only()
    if sys.argv[1:2] in (["dp-times"], ["tiled-times"]):
        return tree_only(sys.argv[1:])
    if sys.argv[1:2] == ["long-routes"]:
        return long_only(sys.argv[1:])
    smi = phase_environment()
    import torch

    from praline_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    os.environ.pop("PRALINE_FUSED_DP", None)  # the default routes, whatever the caller's
    usage = phase_build()
    timing = phase_kernels_vs_plain(dev)
    phase_fused_long(dev, timing)
    phase_fused_clusters(dev, timing)
    fused_times = phase_fused_times(dev)
    tiled_err = phase_tiled_vs_plain(dev)
    tiled_long = phase_tiled_long(dev, usage)
    tiled_times = phase_tiled_times(dev)
    dp_check = phase_dp_vs_plain(dev)
    dp_times = phase_dp_times(dev)
    phase_goldens(dev)
    long_kernels = phase_long_kernels(dev)
    titin = phase_titin_pair(dev)
    probe_times = phase_probes_vs_plain(dev)
    matrix, pairs, cells = headline_pairs()
    all_pairs_run = all_pairs_runner(dev, matrix, pairs)
    msa_seqs = synthetic_family()
    long_seqs = long_family()
    long8_seqs = long8_family()
    compose_times = phase_compose(dev, compose_shapes(msa_seqs, long_seqs, long8_seqs))
    phase_device_merge(dev, "msa128", msa_seqs, ladders=(
        ("pow2", (2047,)), ("headroom1.125", (1151, 1279, 1535))))
    phase_device_merge(dev, "long-family", long_seqs)
    phase_device_merge(dev, "long8", long8_seqs)
    track_pairs, track_cells, track_mats, track_w, tracks_run = tracks_runner(dev)

    # ---- the main paths: launches are counted per path, over its runs only ----
    (res, walls, gcs), c1 = counted(
        "all-pairs", lambda: timed_runs(all_pairs_run, HEADLINE_RUNS, "two_kernel"))
    msa_run, c2 = counted("msa128", lambda: run_msa_twice(dev, msa_seqs, "msa"))
    long_run, c3 = counted("long-family", lambda: run_msa_twice(dev, long_seqs, "long-family"))
    long8_run, c4 = counted("long8", lambda: run_msa_twice(dev, long8_seqs, "long8"))
    (tracks_res, chunks), c5 = counted("tracks", lambda: run_tracks(tracks_run, track_cells, 2, False))
    (tracks_tb, chunks_tb), c6 = counted(
        "tracks-traceback", lambda: run_tracks(tracks_run, track_cells, 1, True))
    _, c7 = counted("utilization", lambda: phase_bench(dev, "utilization"))
    _, c8 = counted("wprobe", lambda: phase_bench(dev, "wprobe"))
    titin_seqs = titin_family()
    long_res, c9 = counted("long-routes", lambda: run_long_routes(dev, titin_seqs))
    tracks_long, c10 = counted("tracks-long", lambda: run_tracks_long(dev))
    mesh_out, c11 = counted("mesh", lambda: phase_mesh(dev, matrix, pairs, msa_seqs))
    homology, c12 = counted("homology", lambda: phase_homology(dev, msa_seqs))
    # ---- end of the main paths; [two-ranks] counts its own, in each rank ----
    scalar_err = homology_scalar_vs_plain(homology.pop("scalar_ops"))
    for name, c, n in (("tracks", c5, chunks), ("tracks-traceback", c6, chunks_tb)):
        if c["scores_mma"] != 2 * n or c["dp"] != n:
            raise AssertionError(f"{name}: {c['scores_mma']} producer and {c['dp']} DP launches "
                                 f"for {n} chunks of two tracks")
    check_tracks(dev, track_pairs, track_mats, track_w, tracks_res, tracks_tb)
    two_ranks = phase_two_ranks(dev, mesh_out["msa_text"], long8_seqs, tracks_res, tracks_tb)
    paths = (c1, c2, c3, c4, c5, c6, c7, c8, c9, c10, c11, c12,
             *two_ranks.pop("launches").values())
    launches = {k: sum(c[k] for c in paths) for k in KERNELS}
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
    cli_profile = phase_cli_profile(dev, msa_seqs)
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
         "max_abs_err": max(timing["scores_err"], timing["scores_edge_err"], scalar_err),
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
         "launches": launches["dp"], "max_abs_err": max(timing["dp_err"], dp_check["err"]),
         "ms": timing["dp_ms"], "plain_ms": timing["dp_plain_ms"],
         **timing["dp_bound"], "library_ms": None, "shape": "B64x1023x1023 global scores",
         "geometry": dp_times["B64x1023x1023_scores"]["geometry"],
         "registers": {f"k{k}_n{n}": "{}regs/{}B-spill-stores/{}B-spill-loads".format(
             *kernel_usage(usage, DP_WALK.format(k=k, n=n)))
             for k in (1, 2, 3, 15) for n in (4, 5)},
         "occupancy": dp_check["occupancy"],
         "lane_slots_per_cell": {t: d["lane_slots_per_cell"] for t, d in dp_times.items()},
         "variants": dp_times},
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
         "library_ms": None, "shape": "B1x4600x4400 local traceback",
         "geometry": tiled_long["geometry"], "variants": tiled_long["variants"],
         "past_8192": tiled_long["past_8192"],
         # beside the fused kernel (K5) and the whole-row DP (K2), scores mode
         "beside": {shape: {k: v for k, v in t.items() if k.startswith("scores_")}
                    for shape, t in tiled_times.items()}},
    ]
    for name, replaces in (("smem_chain", "bench.py:224 (bench_utilization.run_vmem)"),
                           ("alu_chains", "bench.py:256 (bench_utilization.run_alu)"),
                           ("write_blocks", "tools/onchip_wprobe.py:37 (make_writer)")):
        t = probe_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "praline_tpu_torch/csrc/probes.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": t["err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bytes_of": t.get("bytes_of"),
            "library_ms": t.get("library_ms")})
    kernels.append({
        "name": "compose", "route": "cuda", "source": "praline_tpu_torch/csrc/compose.cu",
        "replaces": "praline_tpu/msa/device_merge.py:159-266 (XLA ops of the device merge's "
                    "join body; no Pallas kernel)",
        "launches": launches["compose"], "max_abs_err": compose_times["err"],
        "ms": compose_times["ms"], "plain_ms": compose_times["plain_ms"],
        "bound_ms": compose_times["bound_ms"], "bound_by": compose_times["bound_by"],
        "library_ms": None, "shape": compose_times["shape"],
        "again_ms": compose_times["again_ms"]})
    long_entries = (
        ("tiled_forward", "wavefront_dp_tiled_forward", "praline_tpu_torch/csrc/tiled_ckpt.cu",
         "praline_tpu/kernels/pallas_dp_tiled.py:448 (wavefront_dp_tiled), as the forward pass "
         "of praline_tpu/kernels/scan.py:173 (wavefront_dp_checkpointed)", "forward"),
        ("tiled_resume", "wavefront_dp_tiled_resume", "praline_tpu_torch/csrc/tiled_ckpt.cu",
         "praline_tpu/kernels/pallas_dp_tiled.py:448 (wavefront_dp_tiled), as the block "
         "re-derivation of praline_tpu/kernels/scan.py:173 (wavefront_dp_checkpointed)",
         "resume"),
        ("walk_block", "replay_block", "praline_tpu_torch/csrc/replay.cu",
         "praline_tpu/kernels/scan.py:979-1004 (the checkpointed walk, an XLA scan; no "
         "Pallas kernel)", "walk_block"),
        ("tiled_composite", "wavefront_dp_tiled_composite",
         "praline_tpu_torch/csrc/tiled_composite.cu",
         "praline_tpu/kernels/pallas_dp_tiled.py:448 (wavefront_dp_tiled) over the composite "
         "of praline_tpu/kernels/scores.py:98-122 (the JAX package streams it)", "composite"))
    for key, name, source, replaces, timing_key in long_entries:
        t = long_kernels[timing_key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": t.get("err", 0.0), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"]})
    say("long-routes", titin=json.dumps(titin), paths=json.dumps(long_res),
        tracks_long=json.dumps(tracks_long), cli_profile=json.dumps(cli_profile))
    say("dist", mesh=json.dumps({k: v for k, v in mesh_out.items() if k != "msa_text"}),
        two_ranks=json.dumps(two_ranks), homology=json.dumps(homology))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
