"""Buffered, staleness-weighted per-server aggregation state (port of
``repro.core.events.buffer``).

FedBuff-style semantics: each server folds arriving client contributions
into a running weighted sum and only runs the protocol's aggregation +
combination once the buffer holds ``AsyncSpec.buffer`` arrivals.  A
contribution of age ``a`` (computed against the model ``a`` ticks ago)
folds with weight

    s(a) = 1 / (1 + a)^alpha                       (nonnegative, s(0) = 1)

and the flushed aggregate is the weight-normalized fold

    psi_p = sum_e s_e x_e / sum_e s_e

— an affine combination of the buffered contributions, so when the ages
are drawn independently of the updates the fold is unbiased in
expectation.  At ``alpha = 0`` (or all ages 0) every weight is 1 and the
fold IS the synchronous mean.

The functions here are pure, as the reference's are.  Under the round
graph the event engine keeps one :class:`BufferedServerState` a run and
copies each tick's :func:`fold_tick` / :func:`flush` results into it in
place (:func:`assign`), so every replay reads and writes the same buffers.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def staleness_weights(ages: torch.Tensor, alpha: float) -> torch.Tensor:
    """``1/(1 + age)^alpha`` in float32 — nonnegative, 1 at age 0,
    nonincreasing."""
    return 1.0 / (1.0 + torch.as_tensor(ages).to(torch.float32)) ** alpha


def weighted_fold(x: torch.Tensor, weights: torch.Tensor, axis: int = 0
                  ) -> torch.Tensor:
    """Weight-normalized fold ``sum w x / sum w`` (the unbiased
    contribution reweighting); zero total weight folds to zero."""
    w = torch.as_tensor(weights, device=x.device).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = -1
    w = w.reshape(shape)
    wsum = w.sum(dim=axis, keepdim=True)
    return (w * x).sum(dim=axis) / torch.clamp(wsum.squeeze(axis),
                                                min=1e-12)


class BufferedServerState(NamedTuple):
    """Per-server aggregation buffers."""
    buf_sum: torch.Tensor    # [P, D] staleness-weighted contribution sum
    buf_wsum: torch.Tensor   # [P] folded weight mass
    buf_n: torch.Tensor      # [P] int32 arrivals since the last flush
    version: torch.Tensor    # [P] int32 flush count (the server's clock)
    psi_cache: torch.Tensor  # [P, D] last announced psi (re-announced by
                             # non-flushing servers during a combine, the
                             # resilience runtime's straggler semantics)


def init_buffers(params: torch.Tensor) -> BufferedServerState:
    """Empty buffers; psi_cache seeded with (a copy of) the initial
    params."""
    P = params.shape[0]
    dev = params.device
    return BufferedServerState(
        buf_sum=torch.zeros_like(params),
        buf_wsum=torch.zeros((P,), dtype=torch.float32, device=dev),
        buf_n=torch.zeros((P,), dtype=torch.int32, device=dev),
        version=torch.zeros((P,), dtype=torch.int32, device=dev),
        psi_cache=params.clone())


def fold_tick(buf: BufferedServerState, contrib: torch.Tensor,
              wsum: torch.Tensor, n: torch.Tensor) -> BufferedServerState:
    """Fold one tick's per-server protected contribution into the buffers.

    ``contrib`` [P, D] is the tick's staleness-weighted protected mean,
    ``wsum`` [P] its folded weight mass and ``n`` [P] its valid-arrival
    count."""
    return buf._replace(
        buf_sum=buf.buf_sum + wsum[:, None] * contrib,
        buf_wsum=buf.buf_wsum + wsum,
        buf_n=(buf.buf_n + n).to(torch.int32))


def flush(buf: BufferedServerState, buffer_size: int, *,
          select: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, BufferedServerState]:
    """(flush mask [P], announced psi [P, D], post-flush buffers).

    A server flushes when its buffer holds >= ``buffer_size`` arrivals:
    its announced psi is the weight-normalized fold and its buffers drain;
    a non-flushing server re-announces ``psi_cache``.  The whole buffer
    drains on flush.

    ``select=False`` returns the RAW fold instead of the re-announce
    select (``psi_cache`` in the returned state is still the selected
    value): the graph-combine kernel (K3) selects fold or cache per server
    from ``(fold, old cache, flush mask)`` — see
    :func:`repro_torch.kernels.ops.graph_combine`."""
    do_flush = buf.buf_n >= buffer_size
    psi_fold = buf.buf_sum / torch.clamp(buf.buf_wsum, min=1e-12)[:, None]
    psi = torch.where(do_flush[:, None], psi_fold, buf.psi_cache)
    new_buf = BufferedServerState(
        buf_sum=torch.where(do_flush[:, None], 0.0, buf.buf_sum),
        buf_wsum=torch.where(do_flush, 0.0, buf.buf_wsum),
        buf_n=torch.where(do_flush, 0, buf.buf_n).to(torch.int32),
        version=(buf.version + do_flush.to(torch.int32)).to(torch.int32),
        psi_cache=psi)
    return do_flush, (psi if select else psi_fold), new_buf


def assign(dst: BufferedServerState, src: BufferedServerState) -> None:
    """Copy ``src`` into ``dst``'s tensors in place (the engine's static
    buffers across replays of the tick graph)."""
    for d, s in zip(dst, src):
        d.copy_(s)
