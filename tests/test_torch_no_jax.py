"""The port never imports JAX or the JAX package, and never moves to the
CPU unasked.

A fresh interpreter imports every module of the port and runs
``msa_align`` on the CPU, and must not have pulled in ``jax`` or
``praline_tpu``; a static scan finds no import of either (nor
``torch.compile``) under the package or in ``chip_smoke.py``; asking for
``"cuda"`` without a card raises.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import praline_tpu_torch
from praline_tpu_torch import device as device_mod
from praline_tpu_torch.msa import msa_align

PKG = Path(praline_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def port_modules():
    """Dotted names of every module of the port (``__main__`` runs the CLI
    when imported, so it is left out)."""
    names = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__main__":
            continue
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_importing_the_port_leaves_jax_out():
    """Every module imported and ``msa_align`` run on the CPU: neither
    ``jax`` nor ``praline_tpu`` is loaded."""
    modules = port_modules()
    assert "praline_tpu_torch.kernels.tiled_dp" in modules and "praline_tpu_torch.oracle.msa" in modules
    assert "praline_tpu_torch.kernels.compose" in modules
    assert "praline_tpu_torch.msa.device_merge" in modules
    assert "praline_tpu_torch.util.accuracy" in modules  # the long-routes slice's modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from praline_tpu_torch import ALPHABET_AA, builtin_score_matrix, load_sequence_fasta\n"
        "from praline_tpu_torch import format_alignment_fasta, msa_align\n"
        "seqs = load_sequence_fasta('testdata/family10.fasta', ALPHABET_AA)\n"
        "aln = msa_align(seqs, builtin_score_matrix('blosum62'), device='cpu')\n"
        "assert format_alignment_fasta(aln) == open('testdata/family10.default.golden.fasta').read()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'praline_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_static_scan_finds_no_jax_and_no_compile():
    bad = re.compile(r"^\s*(import jax|from jax)|torch\.compile|scaled_dot_product_attention", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert PKG / "kernels" / "fused_dp.py" in files
    assert PKG / "util" / "accuracy.py" in files and PKG / "util" / "metrics.py" in files
    for path in files:
        assert not bad.search(path.read_text()), path


def test_static_scan_finds_no_import_of_the_jax_package():
    """Absolute or relative-free, direct or inside a function: no module of
    the port and not ``chip_smoke.py`` names ``praline_tpu`` in an import
    unless it is ``praline_tpu_torch``."""
    bad = re.compile(r"^\s*(from\s+praline_tpu|import\s+praline_tpu)(?!_torch)\b", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert PKG / "oracle" / "align.py" in files
    for path in files:
        assert not bad.search(path.read_text()), path
    assert bad.search("from praline_tpu.oracle import x\n")
    assert bad.search("    import praline_tpu\n")
    assert not bad.search("from praline_tpu_torch.oracle import x\n")


def test_chip_smoke_imports_only_the_port():
    """The smoke script reaches the JAX package's host layers only through
    ``praline_tpu_torch``'s re-exports, which import no JAX."""
    src = (ROOT / "chip_smoke.py").read_text()
    direct = re.compile(r"^\s*(from|import)\s+praline_tpu(\.|\s|$)", re.M)
    assert not direct.search(src)
    assert re.search(r"^\s*from praline_tpu_torch import", src, re.M)
    for name in ("ALPHABET_AA", "GAP", "METRICS", "PralineConfig", "Profile",
                 "Sequence", "builtin_score_matrix", "format_alignment_clustal",
                 "format_alignment_fasta", "load_sequence_fasta"):
        assert hasattr(praline_tpu_torch, name), name


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        msa_align([object(), object()], None, device="cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_exactness_switches_are_set():
    device_mod.resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
