"""The port never imports JAX, and never moves to the CPU unasked.

A fresh interpreter imports the port's packages and must not have pulled
in ``jax``; a static scan finds no JAX import and no ``torch.compile``
under the package; asking for ``"cuda"`` without a card raises.
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


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys\n"
        "import praline_tpu_torch, praline_tpu_torch.msa, praline_tpu_torch.cli\n"
        "import praline_tpu_torch.kernels, praline_tpu_torch.convert\n"
        "import praline_tpu_torch.kernels.fused_dp, praline_tpu_torch.kernels.batch\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
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
    for path in files:
        assert not bad.search(path.read_text()), path


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
