"""A run's warm-up round and round-graph capture, host milliseconds, the
mean over the window's runs (the program's capture counters,
``repro_torch.telemetry.profile.compile_counters``)."""
import numpy as np


def read(run):
    capture_s = run.window.get("capture_s")
    if not capture_s:
        return None
    return float(np.mean(capture_s)) * 1e3
