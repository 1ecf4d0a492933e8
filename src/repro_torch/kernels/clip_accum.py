"""K6 ``clip_accum``: per-client clip to the B-ball, then the client mean.

Port of the Pallas kernels in ``repro/kernels/clip_accum.py``.  Two
passes over g [L, D]: the squared norms, which is exactly K1
(``_sumsq_kernel`` is ``_norms_kernel`` at P = 1) and so runs as the
``fold_norms`` kernel on g viewed as [1, L, D]; then ``csrc/clip_accum.cu``,
which turns the [L] norms into clip coefficients and takes the
fixed-order mean.  The norms stay on the device between the passes.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import FLOAT_TYPES, check, on_cuda, stream_handle
from repro_torch.kernels.ref import clip_accum_plain
from repro_torch.kernels.round_fold import launch_norms

__all__ = ["clip_accum", "clip_accum_plain"]

MAX_CLIENTS = 12288            # clip coefficients in 48 KB of shared memory


def clip_accum(grads: torch.Tensor, bound: float) -> torch.Tensor:
    """grads: [L, D] f32/bf16 per-client gradients -> the mean of the
    clipped gradients, [D] in grads' dtype."""
    check(grads, "grads", (None, None), FLOAT_TYPES)
    if not on_cuda(grads):
        return clip_accum_plain(grads, bound)
    L, D = grads.shape
    if L > MAX_CLIENTS:
        raise ValueError(f"clip_accum: L={L} exceeds {MAX_CLIENTS}")
    sq = launch_norms(grads.view(1, L, D)).view(L)
    out = torch.empty((D,), dtype=grads.dtype, device=grads.device)
    fn = _build.function("clip_accum")
    _build.check(fn(grads.data_ptr(), int(grads.dtype == torch.bfloat16),
                    sq.data_ptr(), float(bound), out.data_ptr(), L, D,
                    stream_handle(grads)), "clip_accum")
    _k.LAUNCHES["clip_accum"] += 1
    return out
