"""Build and load the Hopper kernels: nvcc into a plain-C shared library.

Same pattern as the JAX package's C++ twin (``praline_tpu/native/
__init__.py:25-39``): every ``csrc/*.cu`` is compiled once by ``nvcc`` into
one shared library with a plain C interface, cached by a hash of the
sources and flags, and loaded with ``ctypes``.  The build happens at first
use, never at import, and lands in ``praline_tpu_torch/_build/`` (listed
in ``.gitignore``).

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
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LIB: ctypes.CDLL | None = None


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
    return its path.  ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) and prints the compiler's output."""
    so = BUILD_DIR / f"libpraline_kernels_{_tag()}.so"
    if so.exists() and not verbose:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr)
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
        lib.praline_wavefront_dp.restype = i
        lib.praline_wavefront_dp.argtypes = [
            p, p, p, p, i, i, i, i, i, i, p, p, p, p, p, p, p,
        ]
        lib.praline_replay_moves.restype = i
        lib.praline_replay_moves.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p]
        _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
