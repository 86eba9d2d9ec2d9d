"""What holds the tensor-core producer: ``csrc/scores_mma.cu`` beside
copies of itself with one part taken out, timed on the card.

    python -m praline_tpu_torch.producer_ablation

Each variant is the kernel source with one textual substitution, built
by nvcc into its own shared library (``praline_tpu_torch/_build/
ablation/``) and called through the same C entry point:

- ``kernel``: the source as it is;
- ``no_store``: without the copy of each box to ``hs`` (the compute and
  the band copies alone);
- ``no_mma``: without the tensor-core tiles and their epilogue (the
  prep, the band copies and the store of an unwritten box);
- ``prep_only``: the prep kernel alone;
- ``boxes_N``: ``CHUNKS = N`` boxes a block.

Only ``kernel`` and ``boxes_N`` compute ``hs``; each of them is held bit
for bit against the plain version.  Beside them: K9 ``write_blocks`` at
the store pattern of 128 lanes x 128 and x 512 diagonals a block, and
``torch.bmm(Cx @ S, Cy^T)``.  Shapes: the headline's count profiles at
B64 and B512 x 1023 and B16 x 2047, and one-hot profiles at B64 x 1023
(the one-pass case).  Times by CUDA events, the mean of 20 launches,
each variant twice in turn.  Prints one JSON line a shape and the card's
name and power limit; exits 1 without a card.
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
from .kernels import build, probes
from .kernels.fused_scores import mma_scratch_bytes, tier_of
from .kernels.scores import skewed_pair_scores

SOURCE = build.CSRC / "scores_mma.cu"
OUT_DIR = build.BUILD_DIR / "ablation"
CHUNKS_LINE = "constexpr int CHUNKS = 2;"
VARIANTS = {
    "kernel": [],
    "no_store": [("    if (vec) {", "    if (Lp < 0) {"),
                 ("    } else {\n      for (int dd = warp;", "    } else if (Lp < 0) {\n      for (int dd = warp;")],
    "no_mma": [("for (int n = ntile_lo; n < ntile_hi; ++n) {", "for (int n = ntile_lo; n < ntile_lo; ++n) {")],
    "prep_only": [("  skewed_scores_mma_kernel<<<", "  if (B < 0) skewed_scores_mma_kernel<<<")],
    **{f"boxes_{n}": [(CHUNKS_LINE, f"constexpr int CHUNKS = {n};")] for n in (1, 4, 8)},
}
COMPUTES_HS = ("kernel", "boxes_1", "boxes_4", "boxes_8")
SHAPES = ((64, 1023, False), (64, 1023, True), (512, 1023, False), (16, 2047, False))


def variant_source(subs) -> str:
    text = SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{SOURCE.name} no longer holds {old!r}: update the ablation")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """Each variant's library, compiled in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    def compile_one(name):
        src = OUT_DIR / f"{name}.cu"
        src.write_text(variant_source(VARIANTS[name]))
        so = OUT_DIR / f"{name}.so"
        res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so),
                              str(src)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{res.stderr}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.praline_skewed_scores_mma.restype = i
        lib.praline_skewed_scores_mma.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        return name, lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(compile_one, VARIANTS))


def operands(dev, s, B, L, one_hot):
    """The headline's count profiles (or one-hot profiles) of L/2 .. L
    columns at bucket L, both sides, on the card."""
    rng = np.random.default_rng(0)
    A = s.shape[0]
    sides = []
    for _ in range(2):
        profs = count_profiles(rng, B, L // 2, L, A)
        if one_hot:
            for p in profs:
                p.counts[:] = np.eye(A, dtype=np.float32)[rng.integers(0, 20, size=p.length)]
        sides.append(profiles_to_stack(profs, L, dev)[:2])
    return (*sides[0], *sides[1])


def main() -> int:
    if not torch.cuda.is_available():
        print("producer_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    matrix = builtin_score_matrix("blosum62")
    s = matrix_to_torch(matrix, dev)
    for B, L, one_hot in SHAPES:
        cx, ivx, cy, ivy = operands(dev, s, B, L, one_hot)
        if tier_of(cx.cpu().numpy(), cy.cpu().numpy(), matrix.as_f32()) != "mma":
            raise AssertionError("the tensor-core predicate refused the ablation's operands")
        want = skewed_pair_scores(cx, ivx, cy, ivy, s)
        out = torch.empty_like(want)
        scratch = torch.empty(mma_scratch_bytes(B, L, L), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (cx, ivx, cy, ivy, s, out, scratch)]
        times: dict = {}
        for _ in range(2):
            for name, lib in libs.items():
                run = lambda lib=lib: lib.praline_skewed_scores_mma(*ptrs, B, L, L, s.shape[0],
                                                                    stream)
                out.fill_(float("nan"))
                if run() != 0:
                    raise RuntimeError(f"the {name} variant did not launch")
                torch.cuda.synchronize()
                if name in COMPUTES_HS and not torch.equal(out.view(torch.int32),
                                                           want.view(torch.int32)):
                    raise AssertionError(f"the {name} variant differs from the plain version")
                times.setdefault(name, []).append(device_ms(run, 20, dev))
        xv = torch.tensor([[1.5]], device=dev)
        for rows in (128, 512):
            times[f"write_blocks_1x{rows}x128"] = device_ms(
                lambda: probes.write_blocks(xv, block=(1, rows, 128), out=probes.hs_pattern_view(out)),
                20, dev)
        times["bmm"] = device_ms(lambda: torch.bmm(torch.matmul(cx, s), cy.transpose(1, 2)), 20, dev)
        print(json.dumps({"shape": f"B{B}x{L}x{L}", "profiles": "one-hot" if one_hot else "counts",
                          "ms": times}), flush=True)
        del out, want, scratch
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
