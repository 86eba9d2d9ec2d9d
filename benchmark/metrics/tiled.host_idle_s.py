"""Seconds a traced request in which the card is idle while the host is
inside a span of the long routes, innermost: a fused or tiled chunk's
launches (``dispatch:fused:``, ``dispatch:tiled:``, ``kernels/batch.py``)
or the host steps of the fused and tiled kernels' wrappers (``fused:``,
``tiled:``: geometry, operands, launch; ``kernels/fused_dp.py``,
``kernels/tiled_dp.py``).  Summed over the trace's idle gaps whose range
is such a span, over the traced requests; 0.0 where no gap falls in one."""

PREFIXES = ("dispatch:fused:", "dispatch:tiled:", "fused:", "tiled:")


def read(run):
    traced = [r for r in run.requests if r.traced]
    if run.trace is None or not traced:
        return None
    return sum(s for key, s in run.trace.gaps.items()
               if key.split(" / ", 1)[0].startswith(PREFIXES)) / len(traced)
