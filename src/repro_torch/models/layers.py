"""Shared building blocks of the dense and MoE families (mirrors
``repro/models/layers.py``).

Parameters are plain mappings of tensors in the reference's layout
(``{"scale": ...}``, ``{"w_gate": [d, ff], ...}``): a reference param
pytree carries across as a copy, and ``x @ W`` is the same product on both
sides.  Draws come from an explicit :class:`torch.Generator`, on its
device.  LayerNorm, the GELU MLP and cross-entropy wait for the families
and the training slice that need them.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
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


def swiglu_init(gen, d_model, d_ff, dtype) -> dict:
    return {
        "w_gate": he_init(gen, (d_model, d_ff), dtype),
        "w_up": he_init(gen, (d_model, d_ff), dtype),
        "w_down": he_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_init(gen, vocab, d_model, dtype) -> dict:
    return {"table": (_normal(gen, (vocab, d_model)) * 0.02).to(dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding from the embed table."""
    return x @ params["table"].T


def lm_head_init(gen, d_model, vocab, dtype) -> dict:
    return {"w": he_init(gen, (d_model, vocab), dtype)}


def lm_head(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]
