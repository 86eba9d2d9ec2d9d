"""Seconds a traced request in which the card is idle while the host is
inside a ``merge:`` span of the program (``msa/device_merge.py``: plan,
enqueue, node table, compose, collect, assemble), innermost.  Summed over
the trace's idle gaps whose range is such a span, over the traced requests;
0.0 where no gap falls in one."""

PREFIX = "merge:"


def read(run):
    traced = [r for r in run.requests if r.traced]
    if run.trace is None or not traced:
        return None
    return sum(s for key, s in run.trace.gaps.items()
               if key.split(" / ", 1)[0].startswith(PREFIX)) / len(traced)
