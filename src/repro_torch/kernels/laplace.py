"""K7 ``laplace_transform``: uniform draws -> Laplace noise (inverse CDF).

Port of the Pallas kernel in ``repro/kernels/laplace.py``
(``csrc/laplace.cu``): ``u`` [P, D] in (-1/2, 1/2) -> ``-b sign(u)
log1p(-2|u|)`` with ``b = sigma / sqrt(2)``, so the samples have variance
sigma**2.  One elementwise pass, f32 math, one cast to u's dtype; the
kernel masks ragged P and D itself, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import FLOAT_TYPES, check, on_cuda, stream_handle
from repro_torch.kernels.ref import laplace_transform_plain

__all__ = ["laplace_transform", "laplace_transform_plain"]


def laplace_transform(u: torch.Tensor, sigma: float) -> torch.Tensor:
    """u: [P, D] f32/bf16 uniform in (-1/2, 1/2) -> Lap(0, sigma/sqrt 2)
    samples, same shape and dtype."""
    check(u, "u", (None, None), FLOAT_TYPES)
    if not on_cuda(u):
        return laplace_transform_plain(u, sigma)
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    b = float(sigma) / (2.0 ** 0.5)          # in double, as the reference
    fn = _build.function("laplace")
    _build.check(fn(u.data_ptr(), out.data_ptr(),
                    int(u.dtype == torch.bfloat16), u.numel(), b,
                    stream_handle(u)), "laplace_transform")
    _k.LAUNCHES["laplace_transform"] += 1
    return out
