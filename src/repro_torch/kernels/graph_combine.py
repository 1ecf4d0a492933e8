"""K3 ``graph_combine``: fused graph-homomorphic server combination
(eq. 8 + 24).

Port of the Pallas kernel in ``repro/kernels/graph_combine.py``
(``csrc/graph_combine.cu``).  Computes ``A^T (psi_eff + g) - g`` per
feature, ``A^T psi_eff`` when ``g`` is None, with the event engine's
cached-psi re-announce ``psi_eff = gate * psi + (1 - gate) * cache`` when
``gate``/``cache`` are given.  Mixed in f32, never TF32.  No padded copies:
the kernel masks ragged D and takes any P up to 64, and reads A^T from A
as the engines store it, so nothing is transposed or copied.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import FLOAT_TYPES, operand, raw_stream
from repro_torch.kernels.ref import matmul_f32

MAX_P = 64


def graph_combine_plain(A, psi, g=None, *, cache=None, gate=None
                        ) -> torch.Tensor:
    """What the combine kernel computes, in torch (f32 math)."""
    x = psi.to(torch.float32)
    if gate is not None:
        gt = gate.to(torch.float32)[:, None]
        x = gt * x + (1.0 - gt) * cache.to(torch.float32)
    a32 = A.to(torch.float32).T
    if g is None:
        return matmul_f32(a32, x).to(psi.dtype)
    g32 = g.to(torch.float32)
    return (matmul_f32(a32, x + g32) - g32).to(psi.dtype)


def cost(P: int, D: int, esize: int, *, g: bool = False,
         gated: bool = False) -> dict:
    """Bytes and FLOPs of one call at [P, D] (``esize`` bytes an element of
    psi): A read as stored (f32), psi (and g, and cache) read and the
    output written once in psi's dtype, gate (f32) read; the product's 2 P
    P D FLOPs (``dot_flops``), g's add and subtract 2 P D, the gate's blend
    3 P D.  The bound of the smoke's K3 rows and K3's count in the op
    analysis (``launch/op_analysis.py``)."""
    dot = 2 * P * P * D
    return {"bytes": P * P * 4 + (2 + g + gated) * P * D * esize
            + (P * 4 if gated else 0),
            "flops": dot + (2 * P * D if g else 0)
            + (3 * P * D if gated else 0),
            "dot_flops": dot}


def _cost_of(psi, g, gate) -> dict:
    P, D = psi.shape
    return cost(P, D, psi.element_size(), g=g is not None,
                gated=gate is not None)


def graph_combine(A: torch.Tensor, psi: torch.Tensor,
                  g: torch.Tensor | None = None, *,
                  cache: torch.Tensor | None = None,
                  gate: torch.Tensor | None = None) -> torch.Tensor:
    """A: [P, P] f32, the combination matrix as stored (the kernel reads
    its transpose); psi, g, cache: [P, D]; gate: [P] f32 (1 = announce
    psi, 0 = re-announce cache).  Returns [P, D] in psi's dtype.

    The checks are a fixed number of attribute reads, since the main path
    calls this once a round at D = 2, where host time is the cost.  On
    fake tensors (the dry run) it returns the output's shape, launches
    nothing and reports its :func:`cost` to ``kernels.LISTENERS``: a fake
    tensor holds no data for any kernel to read."""
    if psi.dim() != 2 or psi.dtype not in FLOAT_TYPES:
        raise TypeError(f"psi: {psi.dim()}-D {psi.dtype}, expected 2-D "
                        f"f32 or bf16")
    if not psi.is_contiguous():
        raise ValueError("psi: must be contiguous")
    P, D = psi.shape
    dev = psi.device
    if A.shape != (P, P) or A.dtype is not torch.float32 or \
            A.device != dev:
        raise ValueError(f"A: {tuple(A.shape)} {A.dtype} on {A.device}, "
                         f"expected {(P, P)} float32 on {dev}")
    if g is not None:
        operand(g, "g", (P, D), (psi.dtype,), dev)
    if (gate is None) != (cache is None):
        raise ValueError("gate and cache go together")
    if gate is not None:
        operand(cache, "cache", (P, D), (psi.dtype,), dev)
        operand(gate, "gate", (P,), (torch.float32,), dev)
    if dev.type == "cuda" and P > MAX_P:
        raise ValueError(f"graph_combine: P={P} exceeds {MAX_P}")
    if isinstance(psi, FakeTensor):
        _k.report("graph_combine", _cost_of(psi, g, gate))
        return torch.empty_like(psi)
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"no kernel for device {dev}")
        return graph_combine_plain(A, psi, g, cache=cache, gate=gate)
    A = A.contiguous()                          # a no-op on the main path
    out = torch.empty_like(psi)
    # ctypes converts every argument on every call: P and the dtype go as one
    _build.check(_build.function("graph_combine")(
        A.data_ptr(), psi.data_ptr(), None if g is None else g.data_ptr(),
        None if cache is None else cache.data_ptr(),
        None if gate is None else gate.data_ptr(), out.data_ptr(),
        P | (psi.dtype is torch.bfloat16) << 8, D, raw_stream(dev.index)),
        "graph_combine")
    _k.count("graph_combine")
    if _k.LISTENERS:
        _k.report("graph_combine", _cost_of(psi, g, gate))
    return out
