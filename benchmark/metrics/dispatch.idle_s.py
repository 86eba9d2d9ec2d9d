"""Seconds a traced request in which the card is idle while the host is
inside a ``dispatch:`` span of the program (``kernels/batch.py``: a chunk's
launches), innermost: the card waiting for the host's launches.  Summed over
the trace's idle gaps whose range is such a span, over the traced requests;
0.0 where no gap falls in one."""

PREFIX = "dispatch:"


def read(run):
    traced = [r for r in run.requests if r.traced]
    if run.trace is None or not traced:
        return None
    return sum(s for key, s in run.trace.gaps.items()
               if key.split(" / ", 1)[0].startswith(PREFIX)) / len(traced)
