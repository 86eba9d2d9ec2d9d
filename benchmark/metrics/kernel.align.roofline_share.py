"""The scores-and-DP kernels' share of their roofline: the least time the
card could take for the DP work the traced requests need (``roofline.py``:
scores on the int8 tensor cores, the plain step's lane-instructions, bytes
read and written once; every all-pairs pair, and every merge join at the
emitted profiles' widths, since the merge's joins run on these kernels too),
over the device time of every kernel that ``data/kernel_layers.json`` gives
the layer ``kernel.align``."""

from benchmark import roofline


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.layer_seconds(run.layers["kernel.align"])
    if seconds <= 0:
        return None
    traced = [r for r in run.requests if r.traced]
    return 100.0 * roofline.bound_s(run.work(traced, merge=True), run.rates) / seconds
