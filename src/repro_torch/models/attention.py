"""GQA attention with an optional sliding window (mirrors the GQA part of
``repro/models/attention.py``).

Prefill uses query-chunked attention so the [S, S] score matrix is never
materialized; sliding-window archs also restrict each chunk's key slice,
which makes prefill sub-quadratic and lets the KV cache be a ring of
``window`` slots.  Decode writes the new token's K/V into the ring at
``pos % C`` (in place: the port updates the cache where the reference
returns a new one) and sends the attention core through the K8 kernel
(``ops.swa_decode_attention``).  The projections stay ``x @ W``.  MLA and
cross-attention wait for their slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, he_init

NEG_INF = -1e30


def gqa_init(gen, cfg: ModelConfig, dtype) -> dict:
    d, h, kv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "w_q": he_init(gen, (d, h * dh), dtype),
        "w_k": he_init(gen, (d, kv * dh), dtype),
        "w_v": he_init(gen, (d, kv * dh), dtype),
        "w_o": he_init(gen, (h * dh, d), dtype, fan_in=h * dh),
    }


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, dh)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,Sq,KV,G,Dh], k: [B,Sk,KV,Dh] -> [B,KV,G,Sq,Sk] in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                        k.to(torch.float32))


def _chunked_causal_attention(q, k, v, *, window: int, chunk: int):
    """q: [B,S,KV,G,Dh]; k,v: [B,S,KV,Dh].  Causal (+ optional window)
    attention computed in query chunks; never materializes [S, S]."""
    B, S, KV, G, Dh = q.shape
    # 1 / sqrt(Dh) rounded as the reference's f32 does
    scale = float(1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32)))
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    # key slice per chunk: window-limited when that is shorter than the
    # prefix.  The reference slices chunk + window keys whenever
    # window < S, which fails for S < chunk + window; the full prefix,
    # masked, is the same attention there
    klen = chunk + window if window and chunk + window <= S else S
    v32 = v.to(torch.float32)
    outs = []
    for q0 in range(0, S, chunk):
        qc = q[:, q0:q0 + chunk]
        k0 = 0 if klen == S else min(max(q0 - window, 0), S - klen)
        kc, vc = k[:, k0:k0 + klen], v32[:, k0:k0 + klen]
        s = _gqa_scores(qc, kc) * scale               # [B,KV,G,chunk,klen]
        qpos = torch.arange(q0, q0 + chunk, device=q.device)
        kpos = torch.arange(k0, k0 + klen, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, NEG_INF)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", w, vc)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def gqa_forward(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, chunk: int = 1024,
                return_kv: bool = False):
    """Causal self-attention for training / prefill.  x: [B,S,D] -> [B,S,D].

    ``return_kv`` also returns the roped K and the V, [B,S,KV,Dh] each,
    which prefill writes into the cache (the reference projects them a
    second time)."""
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, _ = x.shape
    q = _split_heads(x @ params["w_q"], h, dh)
    k = _split_heads(x @ params["w_k"], kv, dh)
    v = _split_heads(x @ params["w_v"], kv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, torch.arange(S, device=x.device).expand(B, S),
                   cfg.rope_theta)
    q = q.reshape(B, S, kv, h // kv, dh)
    out = _chunked_causal_attention(q, k, v, window=cfg.sliding_window,
                                    chunk=chunk)
    out = out.reshape(B, S, h * dh) @ params["w_o"]
    return (out, k, v) if return_kv else out


# --- KV cache -----------------------------------------------------------


def gqa_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer length: ``window`` slots for SWA archs, else full seq."""
    if cfg.sliding_window and cfg.sliding_window < seq_len:
        return cfg.sliding_window
    return seq_len


def gqa_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   n_layers: int, dtype, device=None) -> dict:
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    clen = gqa_cache_len(cfg, seq_len)
    shape = (n_layers, batch, clen, kv, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def gqa_decode_slots(pos: torch.Tensor, C: int):
    """The ring slot a decode step writes, ``pos % C`` as an int64 [1], and
    the live slot count ``min(pos + 1, C)`` as an int32 [1]; both stay on
    the device.  One step computes them once for all its layers."""
    slot = torch.remainder(pos, C).reshape(1).to(torch.int64)
    nvalid = torch.clamp(pos + 1, max=C).reshape(1)
    return slot, nvalid


def gqa_decode(params, x: torch.Tensor, layer_cache_k: torch.Tensor,
               layer_cache_v: torch.Tensor, pos: torch.Tensor,
               slot: torch.Tensor, nvalid: torch.Tensor, cfg: ModelConfig):
    """Single-token decode.  x: [B,1,D]; caches [B,C,KV,Dh], written in
    place at ``slot``; pos: tokens so far, an int32 tensor on the device;
    slot, nvalid: from ``gqa_decode_slots(pos, C)``.  Returns out [B,1,D]."""
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B = x.shape[0]
    q = _split_heads(x @ params["w_q"], h, dh)
    k = _split_heads(x @ params["w_k"], kv, dh)
    v = _split_heads(x @ params["w_v"], kv, dh)
    posv = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)

    layer_cache_k.index_copy_(1, slot, k)
    layer_cache_v.index_copy_(1, slot, v)
    out = ops.swa_decode_attention(q.reshape(B, h, dh), layer_cache_k,
                                   layer_cache_v, nvalid)
    out = out.reshape(B, 1, h * dh)
    return out @ params["w_o"]
