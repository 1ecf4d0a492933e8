"""GQA attention with an optional sliding window, and multi-head latent
attention (MLA) (mirror the GQA and MLA parts of
``repro/models/attention.py``).

Prefill uses query-chunked attention so the [S, S] score matrix is never
materialized; sliding-window archs also restrict each chunk's key slice,
which makes prefill sub-quadratic and lets the KV cache be a ring of
``window`` slots.  Decode writes the new token's K/V into the ring at
``pos % C`` (in place: the port updates the cache where the reference
returns a new one) and sends the attention core through the K8 kernel
(``ops.swa_decode_attention``).  The projections stay ``x @ W``.

MLA (DeepSeek-V2, MiniCPM3) caches one compressed latent ``c_kv`` [R] and
one roped key [dr] a token, shared by all heads.  Prefill runs it
unabsorbed (the latent expanded to per-head K and V, query-chunked);
decode attends in the latent space with ``w_uk`` folded into the query and
``w_uv`` into the output, in plain f32 einsums: the reference has no
kernel for it, so neither has the port.  Its cache is not a ring: a step
writes at ``pos``, clamped to the last slot as the reference's
``dynamic_update_slice`` clamps.

Under tensor parallelism a rank runs these functions on its own heads:
the caller passes the rank's config (``launch.sharding.local_config``:
its query and K/V head counts) and the rank's blocks of the weights,
gets the rank's partial sum of the ``w_o`` product back, and sums it over
the model group.  K8 then runs on the rank's heads; MLA's down
projections and norms are whole on every rank, so each rank computes and
caches the latents in full, from the replicated input before the group
copy, and copies the latents and the roped key instead (``group=``): in
training those whole leaves get their whole gradient.

Whisper's attention has no rope (``use_rope=False``), its encoder is not
causal, and its decoder cross-attends to the encoder output through K/V
computed once a prefill (:func:`cross_kv`, :func:`cross_attend`, plain
f32 as the reference computes them outside any kernel).
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, he_init, whole
from repro_torch.models.parallel import copy_to_group

NEG_INF = -1e30


def gqa_init(gen, cfg: ModelConfig, dtype, keep=whole) -> dict:
    d, h, kv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "w_q": keep("w_q", he_init(gen, (d, h * dh), dtype)),
        "w_k": keep("w_k", he_init(gen, (d, kv * dh), dtype)),
        "w_v": keep("w_v", he_init(gen, (d, kv * dh), dtype)),
        "w_o": keep("w_o", he_init(gen, (h * dh, d), dtype,
                                   fan_in=h * dh)),
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


def gqa_forward(params, x: torch.Tensor, positions: torch.Tensor | None,
                cfg: ModelConfig, *, chunk: int = 1024,
                use_rope: bool = True, causal: bool = True,
                kv_src: torch.Tensor | None = None,
                return_kv: bool = False):
    """Training / prefill attention.  x: [B,S,D] -> [B,S,D].

    ``kv_src`` is a separate K/V source sequence (cross-attention), which
    implies full attention over it; ``causal=False`` is full
    self-attention (the whisper encoder).  ``return_kv`` also returns the
    K (roped when ``use_rope``) and the V, [B,Sk,KV,Dh] each, which
    prefill writes into the cache (the reference projects them a second
    time)."""
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, _ = x.shape
    src = x if kv_src is None else kv_src
    q = _split_heads(x @ params["w_q"], h, dh)
    k = _split_heads(src @ params["w_k"], kv, dh)
    v = _split_heads(src @ params["w_v"], kv, dh)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        Sk = src.shape[1]
        k = apply_rope(k, torch.arange(Sk, device=x.device).expand(B, Sk),
                       cfg.rope_theta)
    q = q.reshape(B, S, kv, h // kv, dh)
    if causal and kv_src is None:
        out = _chunked_causal_attention(q, k, v, window=cfg.sliding_window,
                                        chunk=chunk)
    else:
        out = _full_attention(q, k, v).to(x.dtype)
    out = out.reshape(B, S, h * dh) @ params["w_o"]
    return (out, k, v) if return_kv else out


def _full_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention in f32.  q: [B,Sq,KV,G,Dh]; k, v: [B,Sk,KV,Dh]
    -> [B,Sq,KV,G,Dh] f32.  The scores are divided by sqrt(Dh), as the
    reference's full-attention paths do."""
    dh = q.shape[-1]
    s = _gqa_scores(q, k) / _sqrt_f32(dh)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))


@functools.lru_cache(maxsize=None)
def _sqrt_f32(n: int) -> float:
    """sqrt(n) as the reference's f32 gives it: a host constant, made
    outside every dispatch mode (a fake one, the dry run's, holds no
    value to read)."""
    with _disable_current_modes():
        return float(torch.sqrt(torch.tensor(n, dtype=torch.float32)))


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
               slot: torch.Tensor, nvalid: torch.Tensor, cfg: ModelConfig,
               *, use_rope: bool = True):
    """Single-token decode.  x: [B,1,D]; caches [B,C,KV,Dh], written in
    place at ``slot``; pos: tokens so far, an int32 tensor on the device;
    slot, nvalid: from ``gqa_decode_slots(pos, C)``.  Returns out [B,1,D]."""
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B = x.shape[0]
    q = _split_heads(x @ params["w_q"], h, dh)
    k = _split_heads(x @ params["w_k"], kv, dh)
    v = _split_heads(x @ params["w_v"], kv, dh)
    if use_rope:
        posv = pos.reshape(1, 1).expand(B, 1)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)

    layer_cache_k.index_copy_(1, slot, k)
    layer_cache_v.index_copy_(1, slot, v)
    out = ops.swa_decode_attention(q.reshape(B, h, dh), layer_cache_k,
                                   layer_cache_v, nvalid)
    out = out.reshape(B, 1, h * dh)
    return out @ params["w_o"]


def cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K and V [B,Se,KV,Dh] from the encoder output
    [B,Se,D], computed once a prefill in the wider of the two dtypes (an
    f32 encoder output promotes bf16 weights, as in the reference)."""
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch.promote_types(enc_out.dtype, params["w_k"].dtype)
    x = enc_out.to(dt)
    k = _split_heads(x @ params["w_k"].to(dt), kv, dh)
    v = _split_heads(x @ params["w_v"].to(dt), kv, dh)
    return k, v


def cross_attend(params, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention against precomputed (encoder) K/V, in plain f32
    (the reference has no kernel for it).  x: [B,Sq,D]; k_cache, v_cache:
    [B,Se,KV,Dh]."""
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, Sq, _ = x.shape
    q = _split_heads(x @ params["w_q"], h, dh).reshape(B, Sq, kv, h // kv,
                                                      dh)
    out = _full_attention(q, k_cache, v_cache).to(x.dtype)
    return out.reshape(B, Sq, h * dh) @ params["w_o"]


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ModelConfig, dtype, keep=whole) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    R = m.kv_lora_rank
    p = {
        "w_dkv": keep("w_dkv", he_init(gen, (d, R), dtype)),
        "w_kr": keep("w_kr", he_init(gen, (d, dr), dtype)),
        "w_uk": keep("w_uk", he_init(gen, (R, h * dn), dtype, fan_in=R)),
        "w_uv": keep("w_uv", he_init(gen, (R, h * dv), dtype, fan_in=R)),
        "w_o": keep("w_o", he_init(gen, (h * dv, d), dtype, fan_in=h * dv)),
        "kv_norm": torch.ones((R,), dtype=dtype, device=gen.device),
    }
    if m.q_lora_rank:
        p["w_dq"] = keep("w_dq", he_init(gen, (d, m.q_lora_rank), dtype))
        p["w_uq"] = keep("w_uq", he_init(gen, (m.q_lora_rank, h * (dn + dr)),
                                         dtype, fan_in=m.q_lora_rank))
        p["q_norm"] = torch.ones((m.q_lora_rank,), dtype=dtype,
                                 device=gen.device)
    else:
        p["w_q"] = keep("w_q", he_init(gen, (d, h * (dn + dr)), dtype))
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """The latents' RMS norm: eps fixed at 1e-5, not ``cfg.norm_eps``."""
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.to(torch.float32)).to(x.dtype)


def _mla_qkr(params, x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig, group=None):
    """Shared q / compressed-kv / rope-key computation.  x: [B,S,D] ->
    q_nope [B,S,h,dn], q_rope [B,S,h,dr], c_kv [B,S,R], k_rope [B,S,dr].
    The whole leaves read ``x`` as it is; what the rank's heads read goes
    through ``group``'s copy."""
    m: MLAConfig = cfg.mla
    h = cfg.num_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    B, S, _ = x.shape
    if m.q_lora_rank:
        c_q = _rms(x @ params["w_dq"], params["q_norm"])
        q = copy_to_group(c_q, group) @ params["w_uq"]
    else:
        q = copy_to_group(x, group) @ params["w_q"]
    q = q.reshape(B, S, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = _rms(x @ params["w_dkv"], params["kv_norm"])        # [B,S,R]
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]             # [B,S,dr]
    return (q_nope, q_rope, copy_to_group(c_kv, group),
            copy_to_group(k_rope, group))


@functools.lru_cache(maxsize=None)
def _mla_scales(m: MLAConfig) -> tuple:
    """(sqrt(dn + dr), 1 / sqrt(dn + dr)) as the reference's f32 gives
    them: host constants, made outside every dispatch mode (a fake one
    holds no value to read)."""
    r = _sqrt_f32(m.qk_nope_head_dim + m.qk_rope_head_dim)
    with _disable_current_modes():
        # a CPU tensor: the float() reads host memory and syncs nothing
        inv = float(1.0 / torch.tensor(r, dtype=torch.float32))  # gflint: disable=GFL003
    return r, inv


def mla_forward(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, chunk: int = 1024,
                return_kv: bool = False, group=None):
    """Training / prefill MLA (unabsorbed), causal, in query chunks.
    x: [B,S,D] -> [B,S,D] (the rank's partial sum over ``group``, x
    replicated over it and not yet copied).  ``return_kv`` also returns
    c_kv [B,S,R] and k_rope [B,S,dr], which prefill writes into the cache
    (the reference projects them a second time)."""
    m: MLAConfig = cfg.mla
    h = cfg.num_heads
    dn, dv = m.qk_nope_head_dim, m.v_head_dim
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, positions, cfg,
                                            group)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, h, dn)
    v = (c_kv @ params["w_uv"]).reshape(B, S, h, dv)
    scale = _mla_scales(m)[1]

    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    kn32, kr32, v32 = (t.to(torch.float32) for t in (k_nope, k_rope, v))
    kpos = torch.arange(S, device=x.device)
    outs = []
    for q0 in range(0, S, chunk):
        qn = q_nope[:, q0:q0 + chunk].to(torch.float32)
        qr = q_rope[:, q0:q0 + chunk].to(torch.float32)
        s = torch.einsum("bqhd,bshd->bhqs", qn, kn32)
        s = s + torch.einsum("bqhd,bsd->bhqs", qr, kr32)
        s = s * scale
        qpos = torch.arange(q0, q0 + chunk, device=x.device)
        s = s.masked_fill(~(kpos[None, :] <= qpos[:, None]), NEG_INF)
        w = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqs,bshd->bqhd", w, v32).to(x.dtype))
    out = torch.cat(outs, dim=1).reshape(B, S, h * dv) @ params["w_o"]
    return (out, c_kv, k_rope) if return_kv else out


def mla_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   n_layers: int, dtype, device=None) -> dict:
    """The latent cache, [L, B, C, R] and [L, B, C, dr] (not a ring)."""
    m: MLAConfig = cfg.mla
    return {
        "c_kv": torch.zeros((n_layers, batch, seq_len, m.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((n_layers, batch, seq_len,
                               m.qk_rope_head_dim), dtype=dtype,
                              device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode_slot(pos: torch.Tensor, C: int) -> torch.Tensor:
    """The slot a decode step writes, ``min(pos, C - 1)`` as an int64 [1]
    on the device: the reference's ``dynamic_update_slice`` clamps a
    start past the end to the last slot."""
    return torch.clamp(pos, max=C - 1).reshape(1).to(torch.int64)


def mla_decode(params, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor, pos: torch.Tensor,
               slot: torch.Tensor, cfg: ModelConfig):
    """Absorbed-matmul MLA decode: attends in the compressed latent space.
    x: [B,1,D]; cache_ckv [B,C,R] and cache_kr [B,C,dr], written in place
    at ``slot`` (``mla_decode_slot(pos, C)``); slots ``<= pos`` attend.
    Returns out [B,1,D]."""
    m: MLAConfig = cfg.mla
    h = cfg.num_heads
    dn, dv, R = m.qk_nope_head_dim, m.v_head_dim, m.kv_lora_rank
    B = x.shape[0]
    C = cache_ckv.shape[1]
    posv = pos.reshape(1, 1).expand(B, 1)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, posv, cfg)
    cache_ckv.index_copy_(1, slot, c_kv)
    cache_kr.index_copy_(1, slot, k_rope)

    # absorb W_uk into q:  q_eff[h,R] = q_nope[h,dn] @ W_uk[R, h*dn] slice
    ckv32 = cache_ckv.to(torch.float32)
    w_uk = params["w_uk"].reshape(R, h, dn).to(torch.float32)
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.to(torch.float32), w_uk)
    s = torch.einsum("bqhr,bsr->bhqs", q_eff, ckv32)
    s = s + torch.einsum("bqhd,bsd->bhqs", q_rope.to(torch.float32),
                         cache_kr.to(torch.float32))
    s = s / _mla_scales(m)[0]
    valid = torch.arange(C, device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)                                # [B,h,1,C]
    ctx = torch.einsum("bhqs,bsr->bqhr", w, ckv32)
    # absorb W_uv on the way out
    w_uv = params["w_uv"].reshape(R, h, dv).to(torch.float32)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv)
    out = out.to(x.dtype).reshape(B, 1, h * dv)
    return out @ params["w_o"]
