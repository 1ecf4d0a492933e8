"""A round's step less its gradients (the clip, the fold, the noise and
the combine), the benchmark's spans around the step and around its
``grad_fn``, timed on the device by CUDA events, the mean over the
window's rounds, milliseconds."""
import numpy as np


def read(run):
    step_s, grad_s = run.window.get("step_s"), run.window.get("grad_s")
    if not step_s or not grad_s:
        return None
    return float(np.mean(np.subtract(step_s, grad_s))) * 1e3
