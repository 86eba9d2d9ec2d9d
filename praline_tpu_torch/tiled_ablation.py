"""What the lane-tiled DP's score prefetch buys: ``csrc/tiled_dp.cu`` beside
a copy whose hs visits read each score from device memory where the step
consumes it (``__ldg``), instead of from the box of scores that each
thread copied into shared memory by ``cp.async`` during the visit before
(``csrc/hs_visits.cuh``, whose ``HsSource`` the copy replaces).

    python -m praline_tpu_torch.tiled_ablation

Builds both from the sources with nvcc, in parallel, then at each shape
holds both bit for bit against the plain DP and times them on the hs
source at the default geometry (``kernels/tiled_dp.py::tiled_geometry``),
in turns (kernel, direct, direct, kernel), by CUDA events, the mean of 5
launches: B1 x 4600 x 4600 local traceback (long8's rows), B2 x 3000 x
3000 and B64 x 2047 global scores.  Prints one JSON line a shape and the
card's name and power limit; exits 1 without a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .bench import count_profiles, device_ms
from .convert import matrix_to_torch, profiles_to_stack
from .io import builtin_score_matrix
from .kernels import build
from .kernels.fused_dp import empty_outputs
from .kernels.scan import MODES
from .kernels.scan import wavefront_dp as plain_dp
from .kernels.scores import skewed_pair_scores
from .kernels.tiled_dp import tiled_geometry

SOURCE = build.CSRC / "tiled_dp.cu"
OUT_DIR = build.BUILD_DIR / "tiled_ablation"
# The hs source of the "direct" variant, in place of csrc/hs_visits.cuh:
# the same shared-memory layout, no copies; each step reads its score with
# __ldg.
INCLUDE = '#include "hs_visits.cuh"\n'
DIRECT_VISITS = """namespace praline_dp {
struct HsDirect {
  const float* hs;
  int B, Lp, b;
  __device__ __forceinline__ float operator()(int d, int i) const {
    return __ldg(hs + ((size_t)d * B + b) * Lp + i);
  }
};
struct HsVisits {
  HsDirect direct;
  __device__ __forceinline__ HsDirect prepare(int, int, int, int) const { return direct; }
};
struct HsSource {
  const float* hs;
  __host__ __device__ static constexpr int smem(int W, int T) { return hs_smem(W, T); }
  __device__ __forceinline__ bool takes(int) const { return true; }
  template <int Q = 1>
  __device__ __forceinline__ HsVisits visits(const WalkArgs& a, int b, int, float*) const {
    return HsVisits{HsDirect{hs, a.B, a.Lp, b}};
  }
};
}  // namespace praline_dp
"""
VARIANTS = ("kernel", "direct")
# (B, Lx = Ly, shortest length, mode, traceback)
SHAPES = ((1, 4600, 4000, "local", True), (2, 3000, 2500, "global", False),
          (64, 2047, 1024, "global", False))


def variant_source(name: str) -> str:
    """The text of ``csrc/tiled_dp.cu`` for variant ``name``."""
    text = SOURCE.read_text()
    if name == "kernel":
        return text
    if text.count(INCLUDE) != 1:
        raise RuntimeError(f"{SOURCE.name} no longer includes hs_visits.cuh: update the ablation")
    return text.replace(INCLUDE, DIRECT_VISITS)


def build_variants() -> dict:
    """Each variant's library, compiled in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    def compile_one(name):
        src = OUT_DIR / f"{name}.cu"
        src.write_text(variant_source(name))
        so = OUT_DIR / f"{name}.so"
        res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                              "-shared", "-o", str(so), str(src)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{res.stderr}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.praline_tiled_dp_hs.restype = i
        lib.praline_tiled_dp_hs.argtypes = [p, p, p, p, *[i] * 11, *[p] * 8]
        return name, lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(compile_one, VARIANTS))


def main() -> int:
    if not torch.cuda.is_available():
        print("tiled_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    s = matrix_to_torch(builtin_score_matrix("blosum62"), dev)
    gaps = np.ascontiguousarray((11, 1), dtype=np.float32)
    for B, L, lo, mode, traceback in SHAPES:
        rng = np.random.default_rng(0)
        cx, ivx, lx = profiles_to_stack(count_profiles(rng, B, lo, L, s.shape[0]), L, dev)
        cy, ivy, ly = profiles_to_stack(count_profiles(rng, B, lo, L, s.shape[0]), L, dev)
        hs = skewed_pair_scores(cx, ivx, cy, ivy, s)
        want = plain_dp(hs, lx, ly, (11, 1), mode, traceback)
        D, _, Lp = hs.shape
        g = tiled_geometry(Lp, 2)
        if g.carry_scratch:
            raise AssertionError(f"the ablation's geometry {g} needs the carry scratch")
        out = empty_outputs(B, L, L, traceback, dev)
        ptrs = [out[k].data_ptr() for k in ("score", "length", "ti", "tj", "tcode")]
        tb = out["tb"].data_ptr() if traceback else None
        stream = torch.cuda.current_stream().cuda_stream
        times: dict = {}
        for order in (VARIANTS, VARIANTS[::-1]):
            for name in order:
                run = lambda lib=libs[name]: lib.praline_tiled_dp_hs(
                    hs.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                    gaps.ctypes.data_as(ctypes.c_void_p), 2, MODES.index(mode), int(traceback),
                    D, B, Lp, g.W, g.R, g.m, g.T, g.Q, None, *ptrs, tb, stream)
                for t in out.values():
                    t.fill_(0xAB if t.dtype == torch.uint8 else -7)
                if run() != 0:
                    raise RuntimeError(f"the {name} variant did not launch")
                torch.cuda.synchronize()
                if any(not torch.equal(out[k], want[k]) for k in want):
                    raise AssertionError(f"the {name} variant differs from the plain DP")
                times.setdefault(name, []).append(device_ms(run, 5, dev))
        print(json.dumps({"shape": f"B{B}x{L}x{L}", "mode": mode, "traceback": traceback,
                          "geometry": {"R": g.R, "m": g.m, "W": g.W, "T": g.T}, "ms": times}),
              flush=True)
        del hs, out, want
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
