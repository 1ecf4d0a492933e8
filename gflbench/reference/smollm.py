"""A plain SmolLM-135M (hf:HuggingFaceTB/SmolLM-135M), its loss and its
gradients, in float32 with TF32 off.

The Llama architecture as published: token embedding, then per layer
x += Attn(RMSNorm(x)) and x += SwiGLU(RMSNorm(x)); a final RMSNorm and the
tied embedding as the head; the mean next-token cross-entropy.  Attention
is grouped-query (9 query heads share 3 key/value heads, head h reads
key/value head h // 3), causal, scaled by 1/sqrt(64), with rotary
embeddings (theta 10000) on the split-half pairing.  RMSNorm is
x / sqrt(mean(x^2) + eps) * scale, in float32.

Departures from the published model: none in the arithmetic.  The weights
are random (:mod:`gflbench.traffic.weights`), not the published ones.

Parameters travel as one flat [D] float32 vector in a stated layout
(:func:`layout`): the parameter tree's leaves in sorted key order, a
per-layer leaf stacked layer after layer.  The vector a round trains on is
that layout's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Leaf(NamedTuple):
    key: str          # the tree's "/"-joined key
    shape: tuple      # one layer's shape (the leaf's, unstacked)
    layers: int       # 1 for an unstacked leaf
    offset: int       # first flat index

    @property
    def numel(self) -> int:
        return math.prod(self.shape) * self.layers


def layout(cfg: dict) -> list:
    """The flat vector's leaves, in order, for a config with the Hugging
    Face keys of a Llama model."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    n = cfg["num_hidden_layers"]
    stacked = {"blocks/attn/w_k": (d, kv * dh), "blocks/attn/w_o": (h * dh, d),
               "blocks/attn/w_q": (d, h * dh), "blocks/attn/w_v": (d, kv * dh),
               "blocks/ln1/scale": (d,), "blocks/ln2/scale": (d,),
               "blocks/mlp/w_down": (ff, d), "blocks/mlp/w_gate": (d, ff),
               "blocks/mlp/w_up": (d, ff)}
    whole = {"embed/table": (cfg["vocab_size"], d), "final_norm/scale": (d,)}
    leaves, offset = [], 0
    for key in sorted([*stacked, *whole]):
        shape, layers = ((stacked[key], n) if key in stacked
                         else (whole[key], 1))
        leaves.append(Leaf(key, shape, layers, offset))
        offset += leaves[-1].numel
    return leaves


def flat_size(cfg: dict) -> int:
    last = layout(cfg)[-1]
    return last.offset + last.numel


def leaf_norms(flat: torch.Tensor, leaves: list) -> torch.Tensor:
    """[n_leaves] float64 norms of a flat [D] vector's leaves."""
    return torch.stack([torch.linalg.vector_norm(
        flat[lf.offset:lf.offset + lf.numel].to(torch.float64))
        for lf in leaves])


def _params(flat: torch.Tensor, leaves: list) -> dict:
    """{key: [layers, *shape] view of ``flat``} as autograd leaves, one
    tensor a layer so that each gradient is written once."""
    out = {}
    for lf in leaves:
        seg = flat[lf.offset:lf.offset + lf.numel].view(lf.layers, *lf.shape)
        out[lf.key] = [t.detach().requires_grad_() for t in seg.unbind(0)]
    return out


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x [B, S, H, Dh]: rotate pairs (i, i + Dh/2) by position * theta^(-2i/Dh)."""
    S, dh = x.shape[1], x.shape[-1]
    expo = torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh
    freqs = (1.0 / theta ** expo).to(torch.float32)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [B, S] against labels [B, S]."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kv, dh = cfg["num_key_value_heads"], d // cfg["num_attention_heads"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    table = params["embed/table"][0]
    x = table[tokens]
    Bn, S = tokens.shape
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        def p(name):
            return params["blocks/" + name][i]
        a = _rms_norm(x, p("ln1/scale"), eps)
        q = _rope((a @ p("attn/w_q")).view(Bn, S, h, dh), theta)
        k = _rope((a @ p("attn/w_k")).view(Bn, S, kv, dh), theta)
        v = (a @ p("attn/w_v")).view(Bn, S, kv, dh)
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        x = x + o.reshape(Bn, S, h * dh) @ p("attn/w_o")
        a = _rms_norm(x, p("ln2/scale"), eps)
        x = x + (torch.nn.functional.silu(a @ p("mlp/w_gate"))
                 * (a @ p("mlp/w_up"))) @ p("mlp/w_down")
    x = _rms_norm(x, params["final_norm/scale"][0], eps)
    logits = x @ table.T
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def grad(flat: torch.Tensor, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: dict, leaves: list, out: torch.Tensor) -> float:
    """The gradient of :func:`loss` at ``flat`` [D], written into ``out``
    [D]; returns the loss."""
    params = _params(flat, leaves)
    with torch.enable_grad():
        value = loss(params, tokens, labels, cfg)
        flat_leaves = [t for lf in leaves for t in params[lf.key]]
        grads = torch.autograd.grad(value, flat_leaves)
    at = 0
    for g in grads:
        out[at:at + g.numel()].copy_(g.reshape(-1))
        at += g.numel()
    return float(value.detach())
