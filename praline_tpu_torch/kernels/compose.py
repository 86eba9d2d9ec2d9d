"""Profile composition of the device-resident merge: the node table, the
plain version and the Hopper kernel's wrapper (``csrc/compose.cu``).

Counterpart of ``praline_tpu/msa/device_merge.py:159-266``, XLA ops that
the TPU fuses (no Pallas kernel).  For J joins of one tree level at once,
with nothing read back to the host: the walk's move tapes become
full-coverage tapes of the merge mode (semiglobal's free trailing gaps,
local's lead and tail around the segment), the merged profiles are
composed from the two children's columns along them
(``oracle/profile.py::compose_profiles``'s pinned semantics), columns past
``COUNT_LIMIT`` are rescaled in exact integers, and counts, gaps, column
inverses, length and member count go into each join's slot of the node
table.  :func:`compose_plain` states it in torch operations, statement for
statement after the JAX package; on the card it is some 25 launches over
``(J, 2 C_cap, A)`` intermediates, so CUDA tensors take the kernel, one
launch a level.

One deviation from the reference, where its result is discarded anyway: a
merged profile longer than the capacity ``C_cap`` (the caller sees
``nmv > C_cap`` and retries at a larger capacity).  The JAX package clips
such positions onto the last column and adds them up there; here they are
dropped, so that the kernel writes each column once, and the length
stored is ``min(nmv, C_cap)``, so that a later DP never reads past its
rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..oracle.profile import COUNT_LIMIT
from . import build
from .scan import MODES

launches = 0  # kernel launches by compose (not by the plain path)

MAX_ALPHABET = 32  # csrc/compose.cu MAX_ALPHABET


def reset_launches() -> None:
    global launches
    launches = 0


@dataclasses.dataclass
class NodeTable:
    """Every tree node's profile on one device, a slot a node: counts
    ``f32[M, C, A]``, gap counts and column inverses ``f32[M, C]``, lengths
    and member counts ``int32[M]``.  Columns past a node's length hold zero
    counts and inverse 1.0."""

    counts: torch.Tensor
    gaps: torch.Tensor
    inv: torch.Tensor
    lens: torch.Tensor
    mems: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.counts.shape[1]


def inverse_table(max_total: float) -> np.ndarray:
    """Correctly rounded f32 reciprocals ``1 / max(i, 1)`` for every integer
    column total up to ``max(1024, max_total + 2)`` (the reference's table,
    ``praline_tpu/msa/device_merge.py:388-394``), which the kernels index by
    a column's integer total instead of dividing."""
    size = int(max(1024, max_total + 2))
    return (np.float32(1.0) / np.maximum(np.arange(size, dtype=np.float32),
                                         np.float32(1.0))).astype(np.float32)


def column_inverses(counts, inv_table):
    """Each column's inverse looked up from its integer total (numpy or
    torch ``counts [..., A]``, table of the same kind)."""
    if isinstance(counts, torch.Tensor):
        tot = counts.sum(dim=-1).to(torch.int32).clamp(0, inv_table.shape[0] - 1)
        return inv_table[tot.long()]
    tot = counts.sum(axis=-1, dtype=np.float32).astype(np.int32)
    return inv_table[np.clip(tot, 0, inv_table.shape[0] - 1)]


def compose_plain(moves, nmoves, ti, tj, table: NodeTable, li, ri, oi, inv_table, mode,
                  tape_out=None, nmv_out=None):
    """The plain version: ``praline_tpu/msa/device_merge.py:159-266`` in torch
    operations (and the inverse lookup of the next level's gather,
    ``:121-124``).  ``moves uint8[J, steps]`` and ``nmoves``, ``ti``, ``tj``
    ``int32[J]`` are the walk's; ``li``, ``ri``, ``oi`` the joins' child and
    output slots.  Writes the slots ``oi`` of ``table``; returns the
    full-coverage tapes ``uint8[J, steps]`` and their lengths ``int32[J]``
    (into ``tape_out`` / ``nmv_out`` where given)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    J, steps = moves.shape
    C = table.capacity
    li, ri, oi = li.long(), ri.long(), oi.long()
    cl, gl = table.counts.index_select(0, li), table.gaps.index_select(0, li)
    cr, gr = table.counts.index_select(0, ri), table.gaps.index_select(0, ri)
    Cl, nml = table.lens.index_select(0, li), table.mems.index_select(0, li)
    Cr, nmr = table.lens.index_select(0, ri), table.mems.index_select(0, ri)
    m = moves.to(torch.int32)
    nmv = nmoves.to(torch.int32)
    p0 = torch.arange(steps, dtype=torch.int32, device=moves.device)[None, :]
    if mode == "semiglobal":
        tx = Cl - ti
        ty = Cr - tj
        shift = tx + ty
        src = p0 - shift[:, None]
        walk = torch.take_along_dim(m, src.clamp(0, steps - 1).long(), dim=1)
        walk = torch.where(src >= 0, walk, 0)
        m = torch.where(p0 < tx[:, None], 2, torch.where(p0 < shift[:, None], 3, walk))
        nmv = nmv + shift
    elif mode == "local":
        xcnt = ((m == 1) | (m == 2)).sum(dim=1, dtype=torch.int32)
        ycnt = ((m == 1) | (m == 3)).sum(dim=1, dtype=torch.int32)
        empty = nmv == 0
        ti_e = torch.where(empty, 0, ti)
        tj_e = torch.where(empty, 0, tj)
        tx = Cl - ti_e
        ty = Cr - tj_e
        x0 = ti_e - xcnt
        y0 = tj_e - ycnt
        shift = tx + ty
        src = p0 - shift[:, None]
        walk = torch.take_along_dim(m, src.clamp(0, steps - 1).long(), dim=1)
        walk = torch.where((src >= 0) & (src < nmv[:, None]), walk, 0)
        after = shift + nmv
        m = torch.where(
            p0 < ty[:, None], 3,
            torch.where(
                p0 < shift[:, None], 2,
                torch.where(
                    p0 < after[:, None], walk,
                    torch.where(p0 < (after + y0)[:, None], 3,
                                torch.where(p0 < (after + y0 + x0)[:, None], 2, 0)),
                ),
            ),
        )
        nmv = nmv + shift + x0 + y0
    m = m.to(torch.int32)

    valid = m > 0
    takes_x = (m == 1) | (m == 2)
    takes_y = (m == 1) | (m == 3)
    rcx = torch.cumsum(takes_x.to(torch.int32), dim=1, dtype=torch.int32)
    rcy = torch.cumsum(takes_y.to(torch.int32), dim=1, dtype=torch.int32)
    xi = (Cl[:, None] - rcx).clamp(0, C - 1).long()
    yi = (Cr[:, None] - rcy).clamp(0, C - 1).long()
    c_raw = nmv[:, None] - 1 - p0
    keep = valid & (c_raw < C)  # the reference clips c; positions past C drop here
    c = c_raw.clamp(0, C - 1).long()

    wx = (takes_x & keep).to(torch.float32)[:, :, None]
    wy = (takes_y & keep).to(torch.float32)[:, :, None]
    contrib = (torch.take_along_dim(cl, xi[:, :, None], dim=1) * wx
               + torch.take_along_dim(cr, yi[:, :, None], dim=1) * wy)
    fl = nml[:, None].to(torch.float32)
    fr = nmr[:, None].to(torch.float32)
    gap_contrib = torch.where(
        keep,
        torch.where(takes_x, torch.take_along_dim(gl, xi, dim=1), fl)
        + torch.where(takes_y, torch.take_along_dim(gr, yi, dim=1), fr),
        0.0,
    )
    A = cl.shape[2]
    new_counts = torch.zeros((J, C, A), dtype=torch.float32, device=moves.device)
    new_counts.scatter_add_(1, c[:, :, None].expand(-1, -1, A), contrib)
    new_gaps = torch.zeros((J, C), dtype=torch.float32, device=moves.device)
    new_gaps.scatter_add_(1, c, gap_contrib)

    # over-limit rescale in exact integers: (512 c + n) // (2 n)
    totals = new_counts.sum(dim=2) + new_gaps
    over = totals > COUNT_LIMIT
    n_i = totals.to(torch.int32).clamp(min=1)
    c_i = new_counts.to(torch.int32)
    q = torch.div(512 * c_i + n_i[:, :, None], 2 * n_i[:, :, None], rounding_mode="floor")
    qg = torch.div(512 * new_gaps.to(torch.int32) + n_i, 2 * n_i, rounding_mode="floor")
    new_counts = torch.where(over[:, :, None], q.to(torch.float32), new_counts)
    new_gaps = torch.where(over, qg.to(torch.float32), new_gaps)

    table.counts.index_copy_(0, oi, new_counts)
    table.gaps.index_copy_(0, oi, new_gaps)
    table.inv.index_copy_(0, oi, column_inverses(new_counts, inv_table))
    table.lens.index_copy_(0, oi, nmv.clamp(max=C))
    table.mems.index_copy_(0, oi, nml + nmr)
    tape = m.to(torch.uint8)
    if tape_out is not None:
        tape = tape_out.copy_(tape)
    if nmv_out is not None:
        nmv = nmv_out.copy_(nmv)
    return tape, nmv


def compose(moves, nmoves, ti, tj, table: NodeTable, li, ri, oi, inv_table, mode,
            tape_out=None, nmv_out=None):
    """:func:`compose_plain`'s contract; CPU tensors take the plain version,
    CUDA tensors launch the kernel on the current stream (or raise).  The
    slots ``oi`` must differ from every ``li`` and ``ri``."""
    if moves.device.type == "cpu":
        return compose_plain(moves, nmoves, ti, tj, table, li, ri, oi, inv_table, mode,
                             tape_out, nmv_out)
    global launches
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if moves.dtype != torch.uint8 or moves.dim() != 2 or not moves.is_contiguous():
        raise ValueError("moves must be a contiguous uint8[J, steps] tensor")
    J, steps = moves.shape
    M, C, A = table.counts.shape
    dev = moves.device
    if not 1 <= A <= MAX_ALPHABET:
        raise ValueError(f"the kernel takes 1 to {MAX_ALPHABET} residues, got {A}")
    if tape_out is None:
        tape_out = torch.empty((J, steps), dtype=torch.uint8, device=dev)
    if nmv_out is None:
        nmv_out = torch.empty(J, dtype=torch.int32, device=dev)
    want = (("nmoves", nmoves, (J,), torch.int32), ("ti", ti, (J,), torch.int32),
            ("tj", tj, (J,), torch.int32), ("li", li, (J,), torch.int32),
            ("ri", ri, (J,), torch.int32), ("oi", oi, (J,), torch.int32),
            ("counts", table.counts, (M, C, A), torch.float32),
            ("gaps", table.gaps, (M, C), torch.float32), ("inv", table.inv, (M, C), torch.float32),
            ("lens", table.lens, (M,), torch.int32), ("mems", table.mems, (M,), torch.int32),
            ("inv_table", inv_table, (inv_table.shape[0],), torch.float32),
            ("tape_out", tape_out, (J, steps), torch.uint8), ("nmv_out", nmv_out, (J,), torch.int32))
    for name, t, shape, dtype in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on {dev}")
    lib = build.load_library()
    with torch.cuda.device(dev):
        rc = lib.praline_compose(
            moves.data_ptr(), nmoves.data_ptr(), ti.data_ptr(), tj.data_ptr(), li.data_ptr(),
            ri.data_ptr(), oi.data_ptr(), table.counts.data_ptr(), table.gaps.data_ptr(),
            table.inv.data_ptr(), table.lens.data_ptr(), table.mems.data_ptr(),
            inv_table.data_ptr(), inv_table.shape[0], J, C, A, steps, MODES.index(mode),
            tape_out.data_ptr(), nmv_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(rc, "praline_compose")
    launches += 1
    return tape_out, nmv_out
