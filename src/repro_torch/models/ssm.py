"""Mamba2 (SSD) blocks: the chunked prefill path and the O(1)-state decode
step (mirrors ``repro/models/ssm.py``).

The prefill runs the chunked SSD algorithm as the reference does: an
intra-chunk masked [Q, Q] product, each chunk's input-to-state product,
and a scan over the chunk states, with the chunk length Q halved from
``cfg.ssm.chunk`` until it divides S (the chunking sets the float order).
The scan is a Python loop over the chunks carrying ``h`` in f32.  The
reference has no kernel for any of it, so the port has none either: plain
torch on the CPU and on the card.

Heads map to groups as ``jnp.repeat`` maps them (head h reads group
``h // (H / G)``); the port reshapes the heads to [G, H / G] instead of
repeating B and C, which computes the same products.  ``C . B`` is taken
once a group and read by each of its heads.

Above the diagonal of a chunk ``exp(L_t - L_s)`` overflows; the reference
selects 0 there with ``where``.  Here the log-decay differences are set to
-inf before the ``exp``, which gives the same 0 (a 0/1 mask multiplied in
would turn inf into NaN).  The decode step updates its ``h`` and conv
window in place and reads nothing back to the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models.layers import _normal, he_init


def ssm_dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.headdim
    return d_inner, nheads, s.state_dim, s.ngroups


def mamba2_init(gen, cfg: ModelConfig, dtype) -> dict:
    """The reference's shapes and distributions; ``A_log`` is f32 whatever
    ``dtype`` is, as there."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner, H, N, G = ssm_dims(cfg)
    conv_ch = d_inner + 2 * G * N
    dev = gen.device
    return {
        "w_in": he_init(gen, (d, 2 * d_inner + 2 * G * N + H), dtype),
        "conv_w": (_normal(gen, (s.conv_dim, conv_ch)) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "w_out": he_init(gen, (d_inner, d), dtype, fan_in=d_inner),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    d_inner, H, N, G = ssm_dims(cfg)
    return torch.split(proj, [d_inner, d_inner, G * N, G * N, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: [B,S,C]; w: [K,C].  The taps are summed
    in the reference's order, in x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * scale.to(torch.float32)).to(y.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, S)`` halved until it divides S."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


def mamba2_forward(params, x: torch.Tensor, cfg: ModelConfig,
                   h_init: torch.Tensor | None = None):
    """Chunked SSD.  x: [B,S,D] -> ([B,S,D], state {h, conv}).

    The returned state seeds :func:`mamba2_decode` after a prefill: ``h``
    [B,H,P,N] f32 and ``conv`` [B,K-1,C], the last K-1 conv inputs."""
    s: SSMConfig = cfg.ssm
    d_inner, H, N, G = ssm_dims(cfg)
    P = s.headdim
    rep = H // G
    B_, S, _ = x.shape
    Q = _chunk_len(S, s.chunk)
    nc = S // Q
    f32 = torch.float32

    z, xc, Bm, Cm, dt = _split_proj(x @ params["w_in"], cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    K = s.conv_dim
    if S < K - 1:
        conv_tail = F.pad(conv_in, (0, 0, K - 1, 0))[:, S:, :]
    else:
        conv_tail = conv_in[:, S - (K - 1):, :]
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]))
    xc = conv_out[..., :d_inner].reshape(B_, S, H, P)
    Bm = conv_out[..., d_inner:d_inner + G * N].reshape(B_, S, G, N)
    Cm = conv_out[..., d_inner + G * N:].reshape(B_, S, G, N)

    dt = _softplus(dt.to(f32) + params["dt_bias"].to(f32))        # [B,S,H]
    A = -torch.exp(params["A_log"])                                # [H]
    loga = dt * A                                                  # log decay

    # into chunks; heads as [G, rep] so a group's B and C serve its heads
    xc_c = xc.to(f32).reshape(B_, nc, Q, G, rep, P)
    B_c = Bm.to(f32).reshape(B_, nc, Q, G, N)
    C_c = Cm.to(f32).reshape(B_, nc, Q, G, N)
    dt_c = dt.reshape(B_, nc, Q, H)
    L = torch.cumsum(loga.reshape(B_, nc, Q, H), dim=2)            # [B,nc,Q,H]
    Ltot = L[:, :, -1, :]                                          # [B,nc,H]

    # intra-chunk: M[t,s] = exp(L_t - L_s) (C_t . B_s) dt_s  for s <= t
    Lh = L.permute(0, 1, 3, 2)                                     # [B,nc,H,Q]
    M = Lh[..., :, None] - Lh[..., None, :]                        # [B,nc,H,Q(t),Q(s)]
    upper = torch.ones((Q, Q), dtype=torch.bool,
                       device=x.device).triu_(1)
    M.masked_fill_(upper, float("-inf")).exp_()
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", C_c, B_c)               # [B,nc,G,Q,Q]
    M.view(B_, nc, G, rep, Q, Q).mul_(CB[:, :, :, None])
    del CB
    M.mul_(dt_c.permute(0, 1, 3, 2)[:, :, :, None, :])             # dt_s
    Y_intra = torch.einsum("bchqs,bcshp->bcqhp", M,
                           xc_c.reshape(B_, nc, Q, H, P))
    del M

    # chunk input-to-state:  H_c = sum_s exp(Ltot - L_s) dt_s x_s (x) B_s
    w_s = torch.exp(Ltot[:, :, None, :] - L) * dt_c                # [B,nc,Q,H]
    chunk_states = torch.einsum(
        "bcqgrp,bcqgn->bcgrpn",
        w_s.reshape(B_, nc, Q, G, rep, 1) * xc_c,
        B_c).reshape(B_, nc, H, P, N)

    # inter-chunk scan over the chunk states
    h = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device)
         if h_init is None else h_init)
    decay_tot = torch.exp(Ltot)                                    # [B,nc,H]
    h_befores = []
    for c in range(nc):
        h_befores.append(h)                                        # before chunk c
        h = decay_tot[:, c, :, None, None] * h + chunk_states[:, c]
    h_befores = torch.stack(h_befores, dim=1)                      # [B,nc,H,P,N]

    # inter-chunk contribution: y_t += C_t . (exp(L_t) h_before)
    Y_inter = torch.einsum("bcqgn,bcgrpn->bcqgrp", C_c,
                           h_befores.reshape(B_, nc, G, rep, P, N))
    Y_inter = Y_inter.reshape(B_, nc, Q, H, P) * torch.exp(L)[..., None]

    Y = (Y_intra + Y_inter).reshape(B_, S, H, P)
    Y = Y + params["D"].to(f32)[None, None, :, None] * xc.to(f32)
    Y = Y.to(x.dtype).reshape(B_, S, d_inner)
    out = _gated_norm(Y, z, params["norm_scale"])
    return out @ params["w_out"], {"h": h, "conv": conv_tail}


def mamba2_init_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                      device=None) -> dict:
    s: SSMConfig = cfg.ssm
    d_inner, H, N, G = ssm_dims(cfg)
    conv_ch = d_inner + 2 * G * N
    return {
        "h": torch.zeros((n_layers, batch, H, s.headdim, N),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, s.conv_dim - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def mamba2_decode(params, x: torch.Tensor, h_state: torch.Tensor,
                  conv_state: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Single-token step.  x: [B,1,D]; h_state [B,H,P,N] f32 and
    conv_state [B,K-1,C] are advanced in place (the reference returns new
    ones).  Returns out [B,1,D]."""
    s: SSMConfig = cfg.ssm
    d_inner, H, N, G = ssm_dims(cfg)
    P = s.headdim
    rep = H // G
    B_ = x.shape[0]
    f32 = torch.float32

    z, xc, Bm, Cm, dt = _split_proj(x @ params["w_in"], cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)                      # [B,1,C]
    window = torch.cat([conv_state, conv_in], dim=1)               # [B,K,C]
    conv_out = F.silu(torch.sum(window * params["conv_w"][None], dim=1)
                      + params["conv_b"])
    conv_state.copy_(window[:, 1:, :])

    xc = conv_out[..., :d_inner].reshape(B_, G, rep, P)
    Bm = conv_out[..., d_inner:d_inner + G * N].reshape(B_, G, 1, 1, N)
    Cm = conv_out[..., d_inner + G * N:].reshape(B_, G, N)

    dtv = _softplus(dt[:, 0].to(f32) + params["dt_bias"].to(f32))  # [B,H]
    decay = torch.exp(dtv * -torch.exp(params["A_log"]))           # [B,H]

    upd = (dtv.reshape(B_, G, rep, 1, 1) * xc.to(f32)[..., None]
           * Bm.to(f32))                                           # [B,G,rep,P,N]
    h_state.mul_(decay[:, :, None, None]).add_(upd.reshape(B_, H, P, N))
    y = torch.einsum("bgn,bgrpn->bgrp", Cm.to(f32),
                     h_state.reshape(B_, G, rep, P, N)).reshape(B_, H, P)
    y = y + params["D"].to(f32)[None, :, None] * xc.reshape(B_, H, P).to(f32)
    y = y.to(x.dtype).reshape(B_, 1, d_inner)
    out = _gated_norm(y, z, params["norm_scale"])
    return out @ params["w_out"]
