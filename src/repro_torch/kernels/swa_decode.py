"""K8 ``swa_decode``: one-token decode attention over a (ring) KV cache.

Port of the Pallas kernel in ``repro/kernels/swa_decode.py``
(``csrc/swa_decode.cu``).  One query token per sequence against the C
slots of one layer's cache, slots ``>= nvalid`` masked, softmax in f32.
GQA is resolved by indexing (query head h reads KV head ``h // G``), not by
repeating K/V as the reference's wrapper does.  ``nvalid`` stays on the
device: the kernel reads it, so a decode step never waits on the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import FLOAT_TYPES, check, on_cuda, stream_handle
from repro_torch.kernels.ref import swa_decode_attention_plain

MAX_GROUP = 8          # query heads per KV head (one warp each)
MAX_HEAD_DIM = 256

__all__ = ["swa_decode", "swa_decode_attention_plain"]


def _check_cache(t: torch.Tensor, name: str, q: torch.Tensor) -> None:
    B, _, Dh = q.shape
    if t.dim() != 4 or t.shape[0] != B or t.shape[3] != Dh:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"(B={B}, C, KV, Dh={Dh})")
    if t.dtype != q.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected q's {q.dtype}")
    if t.stride(3) != 1 or t.stride(2) != Dh:
        raise ValueError(f"{name}: the (KV, Dh) dims must be dense")


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               nvalid: torch.Tensor) -> torch.Tensor:
    """q: [B, H, Dh]; k, v: [B, C, KV, Dh] (one layer's cache slice, any
    batch and slot strides, KV dividing H); nvalid: [1] int32.  Returns
    [B, H, Dh] in q's dtype."""
    check(q, "q", (None, None, None), FLOAT_TYPES)
    _check_cache(k, "k", q)
    _check_cache(v, "v", q)
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError("k and v must share shape and strides")
    B, H, Dh = q.shape
    C, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"KV heads {KV} do not divide query heads {H}")
    check(nvalid, "nvalid", (1,), (torch.int32,))
    if not on_cuda(q, k, v, nvalid):
        return swa_decode_attention_plain(q, k, v, nvalid)
    if H // KV > MAX_GROUP or Dh > MAX_HEAD_DIM:
        raise ValueError(f"swa_decode: G={H // KV} > {MAX_GROUP} or "
                         f"Dh={Dh} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    fn = _build.function("swa_decode")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    nvalid.data_ptr(), out.data_ptr(),
                    int(q.dtype == torch.bfloat16), B, H, KV, C, Dh,
                    k.stride(0), k.stride(1), 1.0 / math.sqrt(Dh),
                    stream_handle(q)), "swa_decode")
    _k.LAUNCHES["swa_decode"] += 1
    return out
