"""A Llama model's weights drawn from the run's seed, on the device.

One ``torch.Generator`` on the card draws the whole flat [D] float32
vector in one call (:func:`gflbench.reference.smollm.layout`), then each
leaf is scaled in place: a [d_in, d_out] matrix by 1/sqrt(d_in), the
embedding by 0.02, and every RMSNorm scale set to 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gflbench.reference.smollm import flat_size, layout


def flat_weights(cfg: dict, seed: int, device) -> torch.Tensor:
    state = np.random.SeedSequence([seed, 3]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & ((1 << 63) - 1))
    flat = torch.randn(flat_size(cfg), generator=gen, device=device)
    for lf in layout(cfg):
        seg = flat[lf.offset:lf.offset + lf.numel]
        if lf.key.endswith("/scale"):
            seg.fill_(1.0)
        elif lf.key == "embed/table":
            seg.mul_(0.02)
        else:
            seg.mul_(1.0 / math.sqrt(lf.shape[0]))
    return flat
