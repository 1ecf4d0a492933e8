"""The 90th percentile (linear between order statistics) of the wall time
of every run in the window: warm-up round, capture, replays, read-back.
Not the 95th: a few runs in a hundred stall in their graph capture for
0.05 to 0.5 s, and the 95th percentile falls among them, so it swings
with how many a window happens to hold.  What the stalls cost is in
``sec5_rounds_per_s`` (every run and all the window) and in
``sec5_capture_ms``."""
import numpy as np


def read(run):
    unit_s = run.window.get("unit_s")
    if not unit_s:
        return None
    return float(np.percentile(unit_s, 90)) * 1e3
