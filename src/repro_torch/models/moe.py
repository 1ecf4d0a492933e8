"""Mixture-of-Experts layer: top-k router + sort-based capacity dispatch
(mirrors ``repro/models/moe.py``).

Token->expert assignments are stably sorted by expert id, each entry's rank
in its expert's group comes from the group offsets, and the kept entries
(rank < capacity) are copied into a dense [E, C, D] expert buffer, whose
three products are batched matmuls.  Shared experts (DeepSeek style) run
densely beside the routed ones.

Three departures in mechanics, none in the numbers:

- the reference scatter-adds a zero for a dropped entry at the last kept
  slot of its expert; here dropped entries go to a spare row past the
  buffer and kept ones are copied to their (unique) slots;
- the reference's combine scatter-adds each token's k contributions; here
  they are gathered back to [T, k, D] through the inverse of the sort and
  added in k order, so the bits never depend on the order of atomics;
- group offsets come from ``searchsorted`` over the sorted expert ids, not
  a scatter-add of ones: integer math either way, and ``bincount`` would
  read its size on the host.

Nothing here waits on the host: the capacity reads the shape, so a decode
step stays capturable in a CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import he_init, swiglu, swiglu_init


def moe_init(gen, cfg: ModelConfig, dtype) -> dict:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    dff = m.expert_d_ff or cfg.d_ff
    p = {
        "router": he_init(gen, (d, m.num_experts), dtype),
        # stacked expert weights [E, ...]
        "w_gate": he_init(gen, (m.num_experts, d, dff), dtype, fan_in=d),
        "w_up": he_init(gen, (m.num_experts, d, dff), dtype, fan_in=d),
        "w_down": he_init(gen, (m.num_experts, dff, d), dtype, fan_in=dff),
    }
    if m.num_shared_experts:
        p["shared"] = swiglu_init(gen, d, dff * m.num_shared_experts, dtype)
    return p


def capacity(tokens: int, m: MoEConfig) -> int:
    cap = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    cap = max(cap, m.top_k, 4)
    return (cap + 3) // 4 * 4  # pad to a friendly multiple


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig, stats=None):
    """x: [B,S,D] -> (out [B,S,D], aux_loss f32 scalar).

    dispatch="global": one token pool across the whole [B,S] batch;
    dispatch="row": each batch row dispatched on its own, aux the mean of
    the rows'.  ``stats``, a dict, gains ``entries`` (routed entries, an
    int) and ``dropped`` (entries past capacity, a device tensor)."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    if m.dispatch == "row":
        outs, auxes = zip(*(_moe_tokens(params, x[b], cfg, stats)
                            for b in range(B)))
        return torch.stack(outs), torch.stack(auxes).mean()
    out, aux = _moe_tokens(params, x.reshape(B * S, D), cfg, stats)
    return out.reshape(B, S, D), aux


def route(params, xf: torch.Tensor, m: MoEConfig):
    """The router over a flat token pool xf [T,D]: softmax probabilities
    [T,E] in f32, and each token's top-k gates (renormalized) and experts,
    [T,k] each."""
    logits = (xf @ params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, m.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _moe_tokens(params, xf: torch.Tensor, cfg: ModelConfig, stats=None):
    """Core dispatch over a flat token pool.  xf: [T,D]."""
    m: MoEConfig = cfg.moe
    T, D = xf.shape
    E, k = m.num_experts, m.top_k
    C = capacity(T, m)
    dev = xf.device
    probs, gate_vals, gate_idx = route(params, xf, m)

    # ---- sort-based dispatch --------------------------------------------
    e_s, order = torch.sort(gate_idx.reshape(-1), stable=True)   # [T*k]
    tok_s = torch.div(order, k, rounding_mode="floor")   # entry t*k+j: t
    w_s = gate_vals.reshape(-1)[order]
    experts = torch.arange(E, device=dev)
    offsets = torch.searchsorted(e_s, experts)            # group starts
    counts = torch.searchsorted(e_s, experts, right=True) - offsets
    pos = torch.arange(T * k, device=dev) - offsets[e_s]  # rank in group
    keep = pos < C
    dest = e_s * C + torch.clamp(pos, max=C - 1)

    # expert input buffer [E*C, D]: kept entries to their unique slots,
    # dropped ones to a spare row past the end
    xe = xf.new_zeros((E * C + 1, D))
    xe.index_copy_(0, torch.where(keep, dest, E * C), xf[tok_s])
    xe = xe[:E * C].view(E, C, D)

    # ---- expert FFN -------------------------------------------------------
    h = F.silu(torch.bmm(xe, params["w_gate"])) \
        * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"]).reshape(E * C, D)

    # ---- combine: each token's k contributions, added in k order ---------
    gathered = ye[dest] * (w_s * keep)[:, None].to(xf.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    per_tok = gathered[inv].view(T, k, D)
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]

    if m.num_shared_experts:
        out = out + swiglu(params["shared"], xf)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)                                    # [E]
    frac = counts.to(torch.float32) / max(T * k, 1)
    aux = m.router_aux_coef * E * torch.sum(me * frac)
    if stats is not None:
        stats["entries"] = stats.get("entries", 0) + T * k
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()
    return out, aux
