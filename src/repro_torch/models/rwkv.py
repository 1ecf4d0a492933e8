"""RWKV-6 (Finch) blocks: linear attention with a data-dependent decay
(mirrors ``repro/models/rwkv.py``).

Time mixing runs the wkv6 recurrence with a per-channel decay w_t and a
bonus u; channel mixing is the squared-ReLU token-shifted FFN.  The
recurrence is the reference's ``lax.scan`` over time as a Python loop over
t, the state [B,H,hs,hs] carried in f32, four ops a step (the reference's
products and sums, two of them fused as ``addcmul``) and no host read;
a decode step is one turn of it (O(1) state).  The reference has no
kernel for it, so the port has none either.  ``w0`` and ``u`` are f32
whatever the param dtype is, as there; the reference's ``gate_lora`` is
never used there (``w_g`` is [d, d]), nor here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.models.layers import _normal, he_init


def rwkv_dims(cfg: ModelConfig):
    r: RWKVConfig = cfg.rwkv
    return cfg.d_model // r.head_size, r.head_size


def rwkv6_att_init(gen, cfg: ModelConfig, dtype) -> dict:
    r: RWKVConfig = cfg.rwkv
    d = cfg.d_model
    dev = gen.device
    return {
        # token-shift mixing coefficients (5 interpolators + base)
        "mu_x": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "mu": torch.full((5, d), 0.5, dtype=dtype, device=dev),  # w,k,v,r,g
        "maa_w1": he_init(gen, (d, 5 * r.mix_lora), dtype),
        "maa_w2": (_normal(gen, (5, r.mix_lora, d)) * 0.01).to(dtype),
        # decay lora: w = exp(-exp(w0 + tanh(xw @ d1) @ d2))
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "decay_w1": he_init(gen, (d, r.decay_lora), dtype),
        "decay_w2": (_normal(gen, (r.decay_lora, d)) * 0.01).to(dtype),
        "u": (_normal(gen, (d,)) * 0.1).to(torch.float32),
        "w_r": he_init(gen, (d, d), dtype),
        "w_k": he_init(gen, (d, d), dtype),
        "w_v": he_init(gen, (d, d), dtype),
        "w_g": he_init(gen, (d, d), dtype),
        "w_o": he_init(gen, (d, d), dtype),
        "ln_scale": torch.ones((d,), dtype=dtype, device=dev),  # per-head norm
    }


def rwkv6_ffn_init(gen, cfg: ModelConfig, dtype) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "w_k": he_init(gen, (d, dff), dtype),
        "w_v": he_init(gen, (dff, d), dtype, fan_in=dff),
        "w_r": he_init(gen, (d, d), dtype),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for every t; ``prev`` is the carry for position 0.
    x: [B,S,D]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix_inputs(params, x: torch.Tensor, sx: torch.Tensor) -> list:
    """Data-dependent token-shift interpolation -> [xw, xk, xv, xr, xg]."""
    dx = sx - x
    xxx = x + dx * params["mu_x"]
    lora = torch.tanh(xxx @ params["maa_w1"])
    B_, S, _ = x.shape
    lora = lora.reshape(B_, S, 5, -1)
    deltas = torch.einsum("bsfl,fld->fbsd", lora, params["maa_w2"])
    return [x + dx * (params["mu"][f] + deltas[f]) for f in range(5)]


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    lo = torch.tanh(xw @ params["decay_w1"]) @ params["decay_w2"]
    # f32 from here: w0 is f32, lo is cast
    return torch.exp(-torch.exp(params["w0"] + lo.to(torch.float32)))


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm, the population variance (``jnp.var``).
    y: [B,S,H,hs] -> [B,S,H*hs] f32."""
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yf = (yf - mu) * torch.rsqrt(var + eps)
    B_, S = y.shape[:2]
    return yf.reshape(B_, S, -1) * scale.to(torch.float32)


def rwkv6_att_forward(params, x: torch.Tensor, cfg: ModelConfig,
                      state: torch.Tensor | None = None,
                      prev_x: torch.Tensor | None = None):
    """Time mixing.  x: [B,S,D].  Returns (out, (state, last_x)); ``state``
    [B,H,hs,hs] f32 is a new tensor, the one passed in is not written."""
    H, hs = rwkv_dims(cfg)
    B_, S, d = x.shape
    f32 = torch.float32
    if prev_x is None:
        prev_x = torch.zeros((B_, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, prev_x)
    xw, xk, xv, xr, xg = _mix_inputs(params, x, sx)

    # time-major [S,B,H,hs] so a step reads one contiguous slice
    def heads(t):
        return t.reshape(B_, S, H, hs).transpose(0, 1).to(f32).contiguous()

    r = heads(xr @ params["w_r"])
    k = heads(xk @ params["w_k"])
    v = heads(xv @ params["w_v"])
    g = F.silu(xg @ params["w_g"])
    w = heads(_decay(params, xw))
    u = params["u"].reshape(H, hs)[None, :, :, None]               # [1,H,hs,1]

    if state is None:
        state = torch.zeros((B_, H, hs, hs), dtype=f32, device=x.device)
    # the step's operands as views shaped for it: [S,B,H,hs,1] columns
    # (k, w) and [S,B,H,1,hs] rows (v, r)
    k, w = k[..., :, None], w[..., :, None]
    v, r = v[..., None, :], r[..., None, :]
    ys = []
    for t in range(S):
        kv = k[t] * v[t]                                           # [B,H,hs,hs]
        ys.append(torch.matmul(r[t], torch.addcmul(state, u, kv)))  # [B,H,1,hs]
        state = torch.addcmul(kv, w[t], state)
    y = torch.stack(ys, dim=1).reshape(B_, S, H, hs)
    y = _group_norm(y, params["ln_scale"], H).to(x.dtype)
    out = (y * g) @ params["w_o"]
    return out, (state, x[:, -1, :])


def rwkv6_ffn_forward(params, x: torch.Tensor,
                      prev_x: torch.Tensor | None = None):
    """Channel mixing.  x: [B,S,D].  Returns (out, last_x)."""
    B_, S, d = x.shape
    if prev_x is None:
        prev_x = torch.zeros((B_, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, prev_x)
    dx = sx - x
    xk = x + dx * params["mu_k"]
    xr = x + dx * params["mu_r"]
    k = torch.square(F.relu(xk @ params["w_k"]))
    return (torch.sigmoid(xr @ params["w_r"]) * (k @ params["w_v"]),
            x[:, -1, :])


def rwkv6_init_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                     device=None) -> dict:
    H, hs = rwkv_dims(cfg)
    d = cfg.d_model
    return {
        "wkv": torch.zeros((n_layers, batch, H, hs, hs), dtype=torch.float32,
                           device=device),
        "att_x": torch.zeros((n_layers, batch, d), dtype=dtype,
                             device=device),
        "ffn_x": torch.zeros((n_layers, batch, d), dtype=dtype,
                             device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
