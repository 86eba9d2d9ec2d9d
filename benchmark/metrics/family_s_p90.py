"""The 90th percentile of the window's requests' wall seconds, each from its
call until its result is on the host (linear interpolation between order
statistics)."""

import numpy as np


def read(run):
    walls = [r.wall_s for r in run.counted()]
    return float(np.percentile(walls, 90)) if walls else None
