"""K3 ``graph_combine``: fused graph-homomorphic server combination
(eq. 8 + 24).

Port of the Pallas kernel in ``repro/kernels/graph_combine.py``
(``csrc/graph_combine.cu``).  Computes ``A^T (psi_eff + g) - g`` per
feature, ``A^T psi_eff`` when ``g`` is None, with the event engine's
cached-psi re-announce ``psi_eff = gate * psi + (1 - gate) * cache`` when
``gate``/``cache`` are given.  Mixed in f32, never TF32.  No padded copies:
the kernel masks ragged D and takes any P up to 64.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import FLOAT_TYPES, check, on_cuda, stream_handle
from repro_torch.kernels.ref import matmul_f32

MAX_P = 64


def graph_combine_plain(a_t, psi, g=None, *, cache=None, gate=None
                        ) -> torch.Tensor:
    """What the combine kernel computes, in torch (f32 math)."""
    x = psi.to(torch.float32)
    if gate is not None:
        gt = gate.to(torch.float32)[:, None]
        x = gt * x + (1.0 - gt) * cache.to(torch.float32)
    a32 = a_t.to(torch.float32)
    if g is None:
        return matmul_f32(a32, x).to(psi.dtype)
    g32 = g.to(torch.float32)
    return (matmul_f32(a32, x + g32) - g32).to(psi.dtype)


def graph_combine(a_t: torch.Tensor, psi: torch.Tensor,
                  g: torch.Tensor | None = None, *,
                  cache: torch.Tensor | None = None,
                  gate: torch.Tensor | None = None) -> torch.Tensor:
    """a_t: [P, P] f32 (= A^T); psi, g, cache: [P, D]; gate: [P] f32
    (1 = announce psi, 0 = re-announce cache).  Returns [P, D] in psi's
    dtype."""
    check(psi, "psi", (None, None), FLOAT_TYPES)
    P, D = psi.shape
    check(a_t, "a_t", (P, P), (torch.float32,))
    if g is not None:
        check(g, "g", (P, D), (psi.dtype,))
    if (gate is None) != (cache is None):
        raise ValueError("gate and cache go together")
    if gate is not None:
        check(cache, "cache", (P, D), (psi.dtype,))
        check(gate, "gate", (P,), (torch.float32,))
    if not on_cuda(a_t, psi, g, cache, gate):
        return graph_combine_plain(a_t, psi, g, cache=cache, gate=gate)
    if P > MAX_P:
        raise ValueError(f"graph_combine: P={P} exceeds {MAX_P}")
    out = torch.empty_like(psi)
    fn = _build.function("graph_combine")

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(fn(a_t.data_ptr(), psi.data_ptr(), ptr(g), ptr(cache),
                    ptr(gate), out.data_ptr(),
                    int(psi.dtype == torch.bfloat16), P, D,
                    stream_handle(psi)), "graph_combine")
    _k.LAUNCHES["graph_combine"] += 1
    return out
