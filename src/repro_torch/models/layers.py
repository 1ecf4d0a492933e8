"""Shared building blocks of the dense and MoE families (mirrors
``repro/models/layers.py``).

Parameters are plain mappings of tensors in the reference's layout
(``{"scale": ...}``, ``{"w_gate": [d, ff], ...}``): a reference param
pytree carries across as a copy, and ``x @ W`` is the same product on both
sides.  Draws come from an explicit :class:`torch.Generator`, on its
device.  ``jax.nn.gelu`` is the tanh approximation, and ``jnp.var`` the
population variance; the GELU MLP and the LayerNorm here are those.

Under tensor parallelism (a :class:`~repro_torch.models.parallel.ModelGroup`
``group``) the embedding table is split by rows and the head by columns
(vocab-parallel): :func:`embed` looks up the rank's rows alone and sums
over the group, :func:`unembed` and :func:`lm_head` gather the ranks'
logits, and :func:`vocab_parallel_cross_entropy` takes the loss from each
rank's own block of them without the gather.  An init function's
``keep(name, leaf)`` receives each leaf as it is drawn, whole, and
returns what the model keeps (the rank's block,
:func:`repro_torch.launch.sharding.shard_leaf`), so only one whole leaf
is held at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import constant_cache
from repro_torch.models.parallel import (copy_to_group, gather_from_group,
                                         reduce_from_group)


def whole(name: str, leaf: torch.Tensor) -> torch.Tensor:
    """The ``keep`` of a model that holds every leaf whole."""
    return leaf


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def he_init(gen, shape, dtype, fan_in=None) -> torch.Tensor:
    fan_in = fan_in or shape[0]
    return (_normal(gen, shape) / math.sqrt(fan_in)).to(dtype)


def rms_norm_init(dim, dtype, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(dtype)


def layer_norm_init(dim, dtype, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (the population variance), cast back to x's
    dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    out = (x * params["scale"].to(torch.float32)
           + params["bias"].to(torch.float32))
    return out.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@constant_cache
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device = torch.device("cpu")
                     ) -> torch.Tensor:
    """[Dh/2] f32, made once per (head dim, theta, device) and shared: the
    callers only read it."""
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    # theta ** expo taken in f64 (on the host) and rounded once to f32: the
    # correctly rounded value, which the reference's f32 power gives bit for
    # bit at the repo's head dims (64, 96, 128); torch's f32 pow is off by
    # an ulp at Dh=96, which position 5000 turns into 1e-5 of angle
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64),
                            expo.to(torch.float64)).to(torch.float32)
    return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable).  Split-half
    pairing, angles in f32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)               # [Dh/2]
    angles = positions[..., None].to(torch.float32) * freqs     # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                       # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_init(gen, d_model, d_ff, dtype, keep=whole) -> dict:
    return {
        "w_gate": keep("w_gate", he_init(gen, (d_model, d_ff), dtype)),
        "w_up": keep("w_up", he_init(gen, (d_model, d_ff), dtype)),
        "w_down": keep("w_down", he_init(gen, (d_ff, d_model), dtype,
                                         fan_in=d_ff)),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP; with ``w_gate``/``w_up`` split by columns and
    ``w_down`` by rows, the rank's partial sum."""
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def gelu_mlp_init(gen, d_model, d_ff, dtype, keep=whole) -> dict:
    return {
        "w_in": keep("w_in", he_init(gen, (d_model, d_ff), dtype)),
        "b_in": keep("b_in", torch.zeros((d_ff,), dtype=dtype,
                                         device=gen.device)),
        "w_out": keep("w_out", he_init(gen, (d_ff, d_model), dtype,
                                       fan_in=d_ff)),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=gen.device),
    }


def gelu_mlp(params, x: torch.Tensor, group=None) -> torch.Tensor:
    """Whisper's GELU MLP; over a model ``group`` (x replicated) the
    rank's ff block (``w_in``, ``b_in`` and ``w_out`` split), summed over
    it before the whole ``b_out`` is added once."""
    h = F.gelu(copy_to_group(x, group) @ params["w_in"] + params["b_in"],
               approximate="tanh")
    return reduce_from_group(h @ params["w_out"], group) + params["b_out"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_init(gen, vocab, d_model, dtype, keep=whole) -> dict:
    return {"table": keep("table", (_normal(gen, (vocab, d_model))
                                    * 0.02).to(dtype))}


def embed(params, tokens: torch.Tensor, group=None) -> torch.Tensor:
    """The tokens' rows of the table.  Vocab-parallel: the rank's table
    holds rows [index * V/M, (index + 1) * V/M); a token outside them
    looks up zeros, and the sum over the group holds each row once."""
    table = params["table"]
    if group is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens - group.index * n
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, 0)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from_group(rows, group)


def unembed(params, x: torch.Tensor, group=None) -> torch.Tensor:
    """Tied unembedding from the embed table (its rows the rank's vocab
    block under tensor parallelism, the logits gathered)."""
    return gather_from_group(x @ params["table"].T, group)


def lm_head_init(gen, d_model, vocab, dtype, keep=whole) -> dict:
    return {"w": keep("w", he_init(gen, (d_model, vocab), dtype))}


def lm_head(params, x: torch.Tensor, group=None) -> torch.Tensor:
    """The head (its columns the rank's vocab block under tensor
    parallelism, the logits gathered)."""
    return gather_from_group(x @ params["w"], group)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32: logsumexp less the gold logit,
    averaged over the tokens (over the ``mask``ed ones when given).
    logits: [..., V], labels: [...] int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 group, mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """:func:`cross_entropy` of logits split by the vocab over ``group``
    (``logits`` [..., V / M], the rank's block [index * V / M, ...)):
    each rank's logsumexp of its block, the group's M of them side by
    side (:func:`gather_from_group`) and their logsumexp; the gold logit
    summed over the group, each rank giving its own or 0.  The padded
    columns stay in the logsumexp, as :func:`cross_entropy` keeps them."""
    logits = logits.to(torch.float32)
    n = logits.shape[-1]
    block_lse = torch.logsumexp(logits, dim=-1)
    logz = torch.logsumexp(gather_from_group(block_lse[..., None], group),
                           dim=-1)
    local = labels.to(torch.int64) - group.index * n
    mine = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1,
                          torch.where(mine, local, 0)[..., None])[..., 0]
    gold = reduce_from_group(torch.where(mine, picked,
                                         torch.zeros_like(picked)), group)
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
