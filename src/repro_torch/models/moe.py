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

Under tensor parallelism every rank routes every token with the same
(replicated) router and runs the same capacity dispatch, so drops are the
same on every rank, and returns its partial sum, which the caller sums
over the model group: with the ff dim of every expert split (mixtral's
8 experts: ``launch.sharding.param_spec`` splits the experts themselves
only where 16 divides their count), the rank's block of each expert's
products; expert-parallel (DeepSeek's 64), the products of the rank's
block of experts, every other expert's slots contributing zeros.  Shared
experts are split as the dense MLP is.  The router is whole on every
rank and reads the replicated tokens before the group copy
(:func:`~repro_torch.models.parallel.copy_to_group`); the experts read
the copy, and the gates go through a copy of their own, so in training
the router gets its whole gradient from every rank's experts and the
aux loss reaches the tokens once, not once a rank.

Nothing here waits on the host: the capacity reads the shape, so a decode
step stays capturable in a CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import he_init, swiglu, swiglu_init, whole
from repro_torch.models.parallel import copy_to_group


def moe_init(gen, cfg: ModelConfig, dtype, keep=whole) -> dict:
    m: MoEConfig = cfg.moe
    d, E = cfg.d_model, m.num_experts
    dff = m.expert_d_ff or cfg.d_ff
    p = {
        "router": keep("router", he_init(gen, (d, E), dtype)),
        # stacked expert weights [E, ...]
        "w_gate": keep("w_gate", he_init(gen, (E, d, dff), dtype, fan_in=d)),
        "w_up": keep("w_up", he_init(gen, (E, d, dff), dtype, fan_in=d)),
        "w_down": keep("w_down", he_init(gen, (E, dff, d), dtype,
                                         fan_in=dff)),
    }
    if m.num_shared_experts:
        p["shared"] = swiglu_init(
            gen, d, dff * m.num_shared_experts, dtype,
            keep=lambda name, leaf: keep(f"shared/{name}", leaf))
    return p


def capacity(tokens: int, m: MoEConfig) -> int:
    cap = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    cap = max(cap, m.top_k, 4)
    return (cap + 3) // 4 * 4  # pad to a friendly multiple


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig, stats=None,
                group=None):
    """x: [B,S,D] -> (out [B,S,D], aux_loss f32 scalar).

    dispatch="global": one token pool across the whole [B,S] batch;
    dispatch="row": each batch row dispatched on its own, aux the mean of
    the rows'.  ``stats``, a dict, gains ``entries`` (routed entries, an
    int) and ``dropped`` (entries past capacity, a device tensor).  With
    ``params`` a rank's blocks (module note), ``out`` is the rank's
    partial sum; ``group`` places an expert-parallel rank's experts."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    if m.dispatch == "row":
        outs, auxes = zip(*(_moe_tokens(params, x[b], cfg, stats, group)
                            for b in range(B)))
        return torch.stack(outs), torch.stack(auxes).mean()
    out, aux = _moe_tokens(params, x.reshape(B * S, D), cfg, stats, group)
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


def _moe_tokens(params, xf: torch.Tensor, cfg: ModelConfig, stats=None,
                group=None):
    """Core dispatch over a flat token pool.  xf: [T,D], replicated over
    ``group`` (not yet copied to it)."""
    m: MoEConfig = cfg.moe
    T, D = xf.shape
    E, k = m.num_experts, m.top_k
    El = params["w_gate"].shape[0]             # the experts held here
    e0 = 0 if El == E else group.index * El    # the first of them
    C = capacity(T, m)
    dev = xf.device
    probs, gate_vals, gate_idx = route(params, xf, m)
    xf = copy_to_group(xf, group)
    gate_vals = copy_to_group(gate_vals, group)

    # ---- sort-based dispatch --------------------------------------------
    e_s, order = torch.sort(gate_idx.reshape(-1), stable=True)   # [T*k]
    tok_s = torch.div(order, k, rounding_mode="floor")   # entry t*k+j: t
    w_s = gate_vals.reshape(-1)[order]
    experts = torch.arange(E, device=dev)
    offsets = torch.searchsorted(e_s, experts)            # group starts
    counts = torch.searchsorted(e_s, experts, right=True) - offsets
    pos = torch.arange(T * k, device=dev) - offsets[e_s]  # rank in group
    keep = pos < C
    use, e_loc = keep, e_s
    if El != E:     # expert-parallel: the entries of this rank's experts
        mine = (e_s >= e0) & (e_s < e0 + El)
        use, e_loc = keep & mine, torch.where(mine, e_s - e0, 0)
    dest = e_loc * C + torch.clamp(pos, max=C - 1)

    # expert input buffer [El*C, D]: kept entries to their unique slots,
    # dropped ones (and other ranks' experts') to a spare row past the end
    xe = xf.new_zeros((El * C + 1, D))
    xe.index_copy_(0, torch.where(use, dest, El * C), xf[tok_s])
    xe = xe[:El * C].view(El, C, D)

    # ---- expert FFN -------------------------------------------------------
    h = F.silu(torch.bmm(xe, params["w_gate"])) \
        * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"]).reshape(El * C, D)

    # ---- combine: each token's k contributions, added in k order ---------
    gathered = ye[dest] * (w_s * use)[:, None].to(xf.dtype)
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
