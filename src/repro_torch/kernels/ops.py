"""The one place the engines touch the kernel layer (mirrors
``repro/kernels/ops.py``).

Dispatch is by the device of the tensors: on a card the CUDA kernels run,
on the CPU their plain versions do.  Unlike the reference there is no
backend switch, no padding of D to the TPU tile or of L/P to the
sublane count (the kernels mask ragged edges), and no block autotuner —
the launch configuration is fixed.

With a telemetry session, :func:`round_fold` and :func:`graph_combine`
record their dispatch on the ``kernel`` stream (backend ``cuda`` or
``plain``, the analytic HBM bytes of ``launch/roofline.py``) once per
(op, shape, layout, mode) a session, as the reference records once per
newly traced shape: the eager executor calls them every round, the round
graph only in its warm-up and capture.  A record holds host values only,
so it is made under capture too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.clip_accum import clip_accum as _clip
from repro_torch.kernels.graph_combine import graph_combine as _combine
from repro_torch.kernels.laplace import laplace_transform as _laplace
from repro_torch.kernels.round_fold import fold_apply, fold_norms
from repro_torch.kernels.secure_agg import secure_agg_mean as _secure_agg_mean
from repro_torch.kernels.swa_decode import swa_decode
from repro_torch.telemetry.stream import current_session, note


def _record(op: str, key: tuple, **values) -> None:
    """One ``kernel`` record for (op, key), the first time this session
    dispatches it."""
    sess = current_session()
    if sess is None or not sess.claim((op,) + key):
        return
    note("kernel", {"seq": sess.next_seq(), "op": op, **values})


def _backend(t: torch.Tensor) -> dict:
    cuda = t.device.type == "cuda"
    return {"backend": "cuda" if cuda else "plain",
            "interpret": int(not cuda)}


def _record_round_fold(sess, w, grads, mode: str) -> None:
    from repro_torch.launch.roofline import round_pipeline_traffic
    P, L, D = grads.shape
    layout = "per_client" if w.dim() == 3 else "per_server"
    key = (P, L, D, str(grads.dtype), layout, mode)
    if ("round_fold.traffic",) + key in sess.kernels_seen:
        return
    size = grads.element_size()
    fused = round_pipeline_traffic(P, L, D, itemsize=size, mode=mode,
                                   fused=True)
    chain = round_pipeline_traffic(P, L, D, itemsize=size, mode=mode,
                                   fused=False)
    _record("fold_norms", key, d_pad=D, **_backend(grads))
    _record("fold_apply", key, d_pad=D, mode=mode, **_backend(grads))
    _record("round_fold.traffic", key, mode=mode,
            hbm_bytes=float(fused["total"]),
            hbm_bytes_ref=float(chain["total"]),
            pld_passes=int(fused["pld_passes"]), **_backend(grads))


def apply_gate(psi: torch.Tensor, gate: torch.Tensor | None,
               cache: torch.Tensor | None) -> torch.Tensor:
    """Cached-psi re-announce select: gated-off servers contribute
    ``cache``.  ``gate=None`` is the identity."""
    if gate is None:
        return psi
    return torch.where(gate.to(torch.bool)[:, None], psi, cache)


def round_fold(w: torch.Tensor, grads: torch.Tensor, *, mu: float,
               bound: float, pre_w: torch.Tensor | None = None,
               fold_w: torch.Tensor | None = None,
               noise_w: torch.Tensor | None = None, mode: str = "none",
               sigma: float = 0.0, seeds: torch.Tensor | None = None,
               noise: torch.Tensor | None = None):
    """Fused client-side round: [P, L, D] grads -> (psi [P, D], sq [P, L]).

    ``pre_w`` scales gradients BEFORE the sensitivity clip, ``fold_w`` are
    unnormalized fold weights (normalized with a 1e-12 guard), ``noise_w``
    weights the noise/mask term per client (default: the uniform 1/L
    mean).  ``sq`` is the raw squared gradient norm per (server, client)."""
    P, L, _ = grads.shape
    sess = current_session()
    if sess is not None:
        _record_round_fold(sess, w, grads, mode)
    ones = torch.ones((P, L), dtype=torch.float32, device=grads.device)
    pre_w = ones if pre_w is None else pre_w.to(torch.float32)
    fold_w = ones if fold_w is None else fold_w.to(torch.float32)
    noise_w = ones / L if noise_w is None else noise_w.to(torch.float32)

    sq = fold_norms(grads)
    # the tiny [P, L] clip/weight math between the two streaming passes
    nrm = pre_w * torch.sqrt(sq)
    if bound > 0:
        coef = torch.clamp(bound / torch.clamp(nrm, min=1e-12), max=1.0)
    else:
        coef = torch.ones_like(nrm)
    stepscale = (mu * coef * pre_w).contiguous()
    fold_n = (fold_w / torch.clamp(fold_w.sum(dim=1, keepdim=True),
                                   min=1e-12)).contiguous()
    psi = fold_apply(w, grads, stepscale, fold_n, noise_w.contiguous(),
                     mode=mode, sigma=sigma, seeds=seeds, noise=noise)
    return psi, sq


def graph_combine(A: torch.Tensor, psi: torch.Tensor,
                  g: torch.Tensor | None = None, *,
                  cache: torch.Tensor | None = None,
                  gate: torch.Tensor | None = None) -> torch.Tensor:
    """Fused server combination: out = A^T (psi_eff + g) - g, [P, D].

    ``A`` is a runtime operand; ``g=None`` is the noise-free combine;
    ``gate`` [P] / ``cache`` [P, D] is the event engine's cached-psi
    re-announce, applied inside the kernel."""
    if current_session() is not None:
        P, D = psi.shape
        variant = ("gated" if gate is not None else "") + \
            ("noised" if g is not None else "plain")
        _record("graph_combine", (P, D, str(psi.dtype), variant), d_pad=D,
                **_backend(psi))
    gate_f = None if gate is None else gate.to(torch.float32).contiguous()
    return _combine(A.to(torch.float32), psi.contiguous(),
                    None if g is None else g.contiguous(),
                    cache=None if cache is None else cache.contiguous(),
                    gate=gate_f)


def swa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         nvalid) -> torch.Tensor:
    """Flash-style decode attention vs a (ring) KV cache.

    q: [B, H, Dh]; k, v: [B, C, KV, Dh] with KV <= H dividing H (the kernel
    indexes the KV head; nothing is repeated); nvalid: the valid-slot count,
    an int32 tensor (kept on the device) or an int."""
    nvalid = torch.as_tensor(nvalid, device=q.device).reshape(1)
    return swa_decode(q, k, v, nvalid.to(torch.int32))


# ---------------------------------------------------------------------------
# single-server kernels (reached by launch/kernel_bench.py and the tests)
# ---------------------------------------------------------------------------


def secure_agg_mean(updates: torch.Tensor, seed, scale: float = 1.0
                    ) -> torch.Tensor:
    """Masked client mean: [L, D] -> [D].  ``seed`` is a uint32 value, as
    an int32/int64 tensor [1] (kept on the device) or an int."""
    seed = torch.as_tensor(seed, device=updates.device).reshape(1)
    return _secure_agg_mean(updates.contiguous(), seed, scale)


def laplace_transform(u: torch.Tensor, sigma: float) -> torch.Tensor:
    """Uniform (-1/2, 1/2) -> Lap(0, sigma/sqrt 2): [P, D] -> [P, D]."""
    return _laplace(u.contiguous(), sigma)


def clip_accum(grads: torch.Tensor, bound: float) -> torch.Tensor:
    """Per-client clip to B + mean: [L, D] -> [D]."""
    return _clip(grads.contiguous(), bound)
