"""Reading the traced window: device time by kernel, busy time, idle gaps by host range.

The harness runs ``torch.profiler`` (host and card) over requests of their
own after a ``--trace 1`` run's window, exports its Chrome trace into
``TMPDIR`` and reads it here, then deletes it.  Device time is every kernel,
copy and set on the card; busy time is the union of their intervals; an idle
gap is a stretch of the traced requests in which nothing ran on the card,
named by the innermost benchmark range (``record_function``) and the
innermost host operator open on the main thread at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict  # device seconds by name (kernels, copies and sets)
    gaps: dict  # idle seconds by "range / host operator"

    def layer_seconds(self, patterns: list[str]) -> float:
        return sum(s for name, s in self.kernel_s.items() if any(re.search(p, name) for p in patterns))

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.kernel_s), "idle_gaps": top(self.gaps)}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _nest(spans: list[tuple[float, float, str]]) -> list[int]:
    """Each span's enclosing span (-1 for none) in a list of properly nested
    spans sorted by start."""
    parent, stack = [], []
    for k, (a, b, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= a:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(k)
    return parent


def _innermost(spans, starts, parent, t: float) -> str | None:
    """The innermost span open at ``t``: an ancestor of the latest span to
    start at or before ``t``."""
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0 and spans[k][1] <= t:
        k = parent[k]
    return spans[k][2] if k >= 0 else None


def read(path: str, window_range: str) -> Trace:
    """The trace at ``path``, cut to the host range named ``window_range``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == window_range)
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    main = (win["pid"], win["tid"])
    device, kernel_s = [], defaultdict(float)
    ranges, ops = [], []
    for e in events:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                device.append((a, b))
                kernel_s[e["name"]] += (b - a) * 1e-6
        elif (e["pid"], e["tid"]) == main and cat == "user_annotation" and e is not win:
            ranges.append((a, b, e["name"]))
        elif (e["pid"], e["tid"]) == main and cat == "cpu_op":
            ops.append((a, b, e["name"]))
    busy = _union(device)
    ranges.sort(key=lambda s: (s[0], -s[1]))
    ops.sort(key=lambda s: (s[0], -s[1]))
    r_starts, o_starts = [s[0] for s in ranges], [s[0] for s in ops]
    r_parent, o_parent = _nest(ranges), _nest(ops)
    gaps: dict = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            where = _innermost(ranges, r_starts, r_parent, mid) or "harness"
            what = _innermost(ops, o_starts, o_parent, mid) or "python"
            gaps[f"{where} / {what}"] += (b - a) * 1e-6
    return Trace((t1 - t0) * 1e-6, sum(b - a for a, b in busy) * 1e-6, dict(kernel_s), dict(gaps))
