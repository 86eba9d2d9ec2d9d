"""The roofline and write probes (``csrc/probes.cu``): plain versions and
wrappers.

Replace the TPU kernels of the repository's benchmark:

- :func:`alu_chains` for ``bench.py::bench_utilization.run_alu`` (K8):
  ``NACC`` (4, as on the TPU) independent chains per element, seeded
  ``x * (1 + 0.125 c)``,
  each taking ``links`` links of ``v = max(v * 0.999, v - 1.0)`` (the TPU
  kernel's ``ASTEPS * ACH``), then summed in chain order.  Bound on the
  H100: operations (three a link); the chains live in registers.
- :func:`smem_chain` for ``bench.py::bench_utilization.run_vmem`` (K7):
  ``links`` links of the same step per element (the TPU kernel's ``STEPS *
  CHAIN``).  Bound: operations in the count, but every link is a round
  trip through shared memory, the Hopper counterpart of a VMEM round trip,
  so its rate is what a dependent chain through shared memory sustains.
- :func:`write_blocks` for ``tools/onchip_wprobe.py::make_writer`` (K9):
  every element of ``out`` set to ``x[0, 0]``, one write block
  ``block = (pb, rows, lanes)`` a CUDA block, in the grid's order.  Bound:
  bytes (the output written once).  ``out`` may be a strided view whose
  last axis is contiguous, so that a view of the port's ``hs`` layout
  ``f32[D, B, Lp]`` is written as the producers write it
  (:func:`hs_pattern_view`).  Each warp writes whole rows, 16 bytes a
  thread.

The TPU kernels' blocking (one VMEM-resident block, the grid steps) is not
carried over: each kernel takes any shape and its own grid.  The plain
versions repeat the per-element arithmetic with PyTorch operations (K8's
stacks its chains into one tensor); CPU tensors take them, CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import build

# Kernel launches per wrapper (not by the plain versions).
launches = {"alu_chains": 0, "smem_chain": 0, "write_blocks": 0}

NACC = 4  # csrc/probes.cu's chains an element
# The decay as the f32 the TPU kernel and csrc/probes.cu multiply by (a
# 0-dim CPU tensor acts as a scalar on any device).
DECAY = torch.tensor(0.999, dtype=torch.float32)


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def chain_link(v: torch.Tensor) -> torch.Tensor:
    """One link, ``max(v * 0.999, v - 1.0)``, each operation rounded to f32."""
    return torch.maximum(v * DECAY, v - 1.0)


def alu_chains_plain(x: torch.Tensor, links: int) -> torch.Tensor:
    """The plain version of :func:`alu_chains`: the chains stacked on a
    leading axis, one link of all of them a step."""
    seeds = torch.tensor([1.0 + 0.125 * c for c in range(NACC)], dtype=torch.float32,
                         device=x.device)
    v = x[None] * seeds.view(NACC, *([1] * x.dim()))
    for _ in range(links):
        v = chain_link(v)
    acc = v[0]
    for c in range(1, NACC):
        acc = acc + v[c]
    return acc


def smem_chain_plain(x: torch.Tensor, links: int) -> torch.Tensor:
    """The plain version of :func:`smem_chain`."""
    v = x.clone()
    for _ in range(links):
        v = chain_link(v)
    return v


def write_blocks_plain(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`write_blocks`: ``x[0, 0]`` broadcast.
    (The TPU kernel writes ``x[0, 0] + zeros``, which XLA folds to the
    broadcast: ``-0.0`` stays ``-0.0``.)"""
    out.copy_(x.reshape(-1)[0].expand(out.shape))
    return out


def _check_f32(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def alu_chains(x: torch.Tensor, links: int) -> torch.Tensor:
    """``f32`` of ``x``'s shape: per element, ``NACC`` chains of ``links``
    links summed in chain order.  One CUDA thread an element."""
    if links < 0:
        raise ValueError(f"links must be >= 0, got {links}")
    if x.device.type == "cpu":
        return alu_chains_plain(x, links)
    _check_f32(x, "x")
    out = torch.empty_like(x)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.praline_alu_chains(x.data_ptr(), out.data_ptr(), x.numel(), links,
                                    _stream(x.device))
    build.check(rc, "praline_alu_chains")
    launches["alu_chains"] += 1
    return out


def smem_chain(x: torch.Tensor, links: int) -> torch.Tensor:
    """``f32`` of ``x``'s shape: per element, ``links`` links, each read
    from and written back to shared memory on the card."""
    if links < 0:
        raise ValueError(f"links must be >= 0, got {links}")
    if x.device.type == "cpu":
        return smem_chain_plain(x, links)
    _check_f32(x, "x")
    out = torch.empty_like(x)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.praline_smem_chain(x.data_ptr(), out.data_ptr(), x.numel(), links,
                                    _stream(x.device))
    build.check(rc, "praline_smem_chain")
    launches["smem_chain"] += 1
    return out


def write_blocks(x: torch.Tensor, shape=None, block=(16, 128, 128), *, out=None) -> torch.Tensor:
    """Every element of a 3-d f32 tensor set to ``x[0, 0]``: ``out``
    (a view whose last axis is contiguous), or a new tensor of ``shape``.
    On the card each CUDA block writes one ``block = (pb, rows, lanes)``
    write block, clipped at the edges."""
    if out is None:
        out = torch.empty(tuple(shape), dtype=torch.float32, device=x.device)
    if out.dim() != 3 or out.dtype != torch.float32 or out.device != x.device:
        raise ValueError("out must be a 3-d f32 tensor on x's device")
    if x.dtype != torch.float32 or x.numel() < 1:
        raise ValueError("x must be a non-empty f32 tensor")
    if len(block) != 3 or min(block) < 1:
        raise ValueError(f"block must be three positive sizes, got {block}")
    if x.device.type == "cpu":
        return write_blocks_plain(x, out)
    if out.stride(2) != 1:
        raise ValueError("out's last axis must be contiguous")
    n0, n1, n2 = out.shape
    lib = build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.praline_write_blocks(x.data_ptr(), out.data_ptr(), n0, n1, n2, out.stride(0),
                                      out.stride(1), *block, _stream(x.device))
    build.check(rc, "praline_write_blocks")
    launches["write_blocks"] += 1
    return out


def hs_pattern_view(hs: torch.Tensor) -> torch.Tensor:
    """``hs f32[D, B, Lp]`` seen as ``[B, D, Lp]``: with block ``(1, 128,
    128)``, :func:`write_blocks` then stores as ``csrc/scores.cu`` does (a
    block a problem's 128 lanes x 128 diagonals, lane blocks fastest, then
    diagonal blocks, then problems)."""
    return hs.permute(1, 0, 2)


# csrc/scores.cu's write block in hs_pattern_view's axes.
HS_BLOCK = (1, 128, 128)
