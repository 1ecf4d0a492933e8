"""The clients' gradients of a round (every client's forward and
backward), the benchmark's span around the step's ``grad_fn``, timed on
the device by CUDA events, the mean over the window's rounds,
milliseconds."""
import numpy as np


def read(run):
    grad_s = run.window.get("grad_s")
    if not grad_s:
        return None
    return float(np.mean(grad_s)) * 1e3
