"""State carried across from the reference, through numpy.

The reference's ``GFLState`` and ``LogisticProblem`` hold jax arrays; a
caller passes them here as numpy arrays (``np.asarray``) and gets the
port's own types on ``device``, so both packages compute on the same
numbers.  No jax is imported on this side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.gfl import GFLState
from repro_torch.core.simulate import LogisticProblem


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def gfl_state_from_numpy(params, step, device=None) -> GFLState:
    """GFLState from the reference's ``params`` [P, D] and ``step``."""
    return GFLState(_tensor(params, resolve_device(device)),
                    int(np.asarray(step)))


def problem_from_numpy(features, labels, rho, w_opt,
                       device=None) -> LogisticProblem:
    """LogisticProblem from the reference's arrays."""
    dev = resolve_device(device)
    return LogisticProblem(_tensor(features, dev), _tensor(labels, dev),
                           float(rho), _tensor(w_opt, dev))
