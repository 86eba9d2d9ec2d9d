"""Build and load the Hopper kernels: nvcc into a plain-C shared library.

Same pattern as the JAX package's C++ twin (``praline_tpu/native/
__init__.py:25-39``): every ``csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, cached by a hash of the sources and
flags, and loaded with ``ctypes``.  The build happens at first use, never
at import, and lands in ``praline_tpu_torch/_build/`` (listed in
``.gitignore``).

``--fmad=false`` keeps every f32 multiply and add separately rounded, the
nvcc counterpart of the twin's ``-ffp-contract=off``; there is no
``--use_fast_math``, and the kernels never divide.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

_LIB: ctypes.CDLL | None = None
# Seconds each source took to compile in the last build of this process
# (the sources compile in parallel, so the build took about the largest).
last_build_seconds: dict[str, float] = {}
# The compiler's output per source in the last verbose build: with
# ``-Xptxas -v``, each kernel's registers, shared memory and spills.
last_build_log: dict[str, str] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return nvcc


def _tag() -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists;
    return its path.  ``verbose`` compiles anew with ``-Xptxas -v``
    (registers, shared memory and spills per kernel) and keeps the
    compiler's output in :data:`last_build_log`."""
    tag = _tag()
    so = BUILD_DIR / f"libpraline_kernels_{tag}.so"
    if so.exists() and not verbose:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    objs = {src: BUILD_DIR / f"{src.stem}.{tag}.{os.getpid()}.o" for src in sources()}

    def compile_one(src: Path):
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(objs[src]), str(src)],
                             capture_output=True, text=True)
        return res, time.perf_counter() - t0

    with ThreadPoolExecutor(len(objs)) as pool:
        done = dict(zip(objs, pool.map(compile_one, objs)))
    last_build_seconds.clear()
    last_build_log.clear()
    for src, (res, seconds) in done.items():
        last_build_seconds[src.name] = seconds
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:
            last_build_log[src.name] = res.stdout + res.stderr
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs.values())], capture_output=True, text=True)
    for obj in objs.values():
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    tmp.replace(so)
    return so


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.praline_skewed_scores.restype = i
        lib.praline_skewed_scores.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.praline_skewed_scores_mma.restype = i
        lib.praline_skewed_scores_mma.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.praline_wavefront_dp.restype = i
        lib.praline_wavefront_dp.argtypes = [
            p, p, p, p, i, i, i, i, i, i, p, p, p, p, p, p, p,
        ]
        lib.praline_fused_dp.restype = i
        lib.praline_fused_dp.argtypes = [*[p] * 8, *[i] * 11, *[p] * 8]
        lib.praline_fused_dp_clusters.restype = i
        lib.praline_fused_dp_clusters.argtypes = [i, i, i, i, i, p]
        lib.praline_fused_dp_smem.restype = i
        lib.praline_fused_dp_smem.argtypes = [i, i, i, i]
        lib.praline_tiled_dp_hs.restype = i
        lib.praline_tiled_dp_hs.argtypes = [p, p, p, p, *[i] * 8, *[p] * 8]
        lib.praline_tiled_dp_rows.restype = i
        lib.praline_tiled_dp_rows.argtypes = [*[p] * 8, *[i] * 9, *[p] * 10]
        lib.praline_replay_moves.restype = i
        lib.praline_replay_moves.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p]
        ll = ctypes.c_longlong
        lib.praline_alu_chains.restype = i
        lib.praline_alu_chains.argtypes = [p, p, ll, ll, p]
        lib.praline_smem_chain.restype = i
        lib.praline_smem_chain.argtypes = [p, p, ll, ll, p]
        lib.praline_write_blocks.restype = i
        lib.praline_write_blocks.argtypes = [p, p, i, i, i, ll, ll, i, i, i, p]
        _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
