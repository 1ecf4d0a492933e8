"""RWKV-6 (Finch) blocks: linear attention with a data-dependent decay
(mirrors ``repro/models/rwkv.py``).

Time mixing runs the wkv6 recurrence with a per-channel decay w_t and a
bonus u; channel mixing is the squared-ReLU token-shifted FFN.  The
recurrence is the reference's ``lax.scan`` over time as a Python loop over
t, the state [B,H,hs,hs] carried in f32, four ops a step (the reference's
products and sums, two of them fused as ``addcmul``) and no host read;
a decode step is one turn of it (O(1) state).  On fake tensors (the dry
run) a loop of more than one step is not traced but reported by its cost
(:func:`time_loop_cost`).  The reference has no
kernel for it, so the port has none either.  ``w0`` and ``u`` are f32
whatever the param dtype is, as there; the reference's ``gate_lora`` is
never used there (``w_g`` is [d, d]), nor here.

Under tensor parallelism (a model ``group`` of M ranks) a rank runs its
ceil(H / M) heads (``sharding.padded_heads``: the heads padded with zero
heads to a multiple of M, so 40 heads run over 16 ranks as 48): its
columns of ``w_r``, ``w_k``, ``w_v``, ``w_g`` and of the channel mix's
``w_k``, its rows of both ``w_o`` and ``w_v``, and its channels of ``u``
and ``ln_scale``.  A zero head's columns and rows are 0, and it reads 0
for ``u`` and ``ln_scale`` (and a finite decay): its r, k, v and g are 0,
its state stays 0, its per-head norm maps 0 to 0 with a finite backward,
and its ``w_o`` rows add exactly 0 to the f32 sum, so its gradients are
exactly 0 too.  The token-shift mixes, the decay's
LoRA and the channel mix's ``w_r`` gate read the replicated input whole,
before the group copy; the decay is copied whole and the rank takes its
channels.  The two out products sum their partials in f32
(``parallel.row_parallel``): the recurrence carries each rounding of the
residual stream into its state at every token, and bf16 partials put a
split rwkv6-3b's logits past the bound the other families meet.  The state holds the rank's heads; the token-shift carries
stay whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import kernels as _k
from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.launch import sharding
from repro_torch.models.layers import _normal, he_init, whole
from repro_torch.models.parallel import (copy_all_to_group, copy_to_group,
                                         group_size, row_parallel)


def rwkv_dims(cfg: ModelConfig, group=None):
    """(heads, head size) of the layer, or of the rank over ``group``:
    ceil(H / M), its zero heads included (``sharding.padded_heads``)."""
    hs = cfg.rwkv.head_size
    return -(-sharding.rwkv_heads(cfg) // group_size(group)), hs


def _mine(x: torch.Tensor, cfg: ModelConfig, group) -> torch.Tensor:
    """``x``'s entries on the rank's channels (its heads', last dim
    d_model), 0 on a zero head's: a view of its real heads' run where it
    has no zero head."""
    if group is None:
        return x
    hs = cfg.rwkv.head_size
    mine = sharding.heads(cfg, group.size).q[group.index]
    real = [j for j in mine if j >= 0]
    a = real[0] * hs if real else 0
    part = x[..., a:a + len(real) * hs]
    pad = (len(mine) - len(real)) * hs
    return F.pad(part, (0, pad)) if pad else part


def rwkv6_att_init(gen, cfg: ModelConfig, dtype, keep=whole) -> dict:
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
        **{w: keep(w, he_init(gen, (d, d), dtype))
           for w in ("w_r", "w_k", "w_v", "w_g", "w_o")},
        "ln_scale": torch.ones((d,), dtype=dtype, device=dev),  # per-head norm
    }


def rwkv6_ffn_init(gen, cfg: ModelConfig, dtype, keep=whole) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "w_k": keep("w_k", he_init(gen, (d, dff), dtype)),
        "w_v": keep("w_v", he_init(gen, (dff, d), dtype, fan_in=dff)),
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


def _decay_exponent(params, xw: torch.Tensor) -> torch.Tensor:
    """w0 + the decay LoRA of ``xw``, f32 (w0 is f32, the LoRA cast)."""
    lo = torch.tanh(xw @ params["decay_w1"]) @ params["decay_w2"]
    return params["w0"] + lo.to(torch.float32)


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    """The data-dependent decay w = exp(-exp(w0 + LoRA(xw))), f32."""
    return torch.exp(-torch.exp(_decay_exponent(params, xw)))


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


def time_loop(r, k, v, w, u, state):
    """The wkv6 recurrence over time: r, k, v, w [S,B,H,hs] f32
    time-major, u [1,H,hs,1], state [B,H,hs,hs] f32.  Returns (y
    [B,S,H,hs], the new state).  On fake tensors over more than one step
    (the dry run) it runs nothing and reports its cost
    (:class:`_ModelledLoop`)."""
    S, B_, H, hs = r.shape
    if S > 1 and isinstance(r, FakeTensor):
        return _ModelledLoop.apply(r, k, v, w, u, state)
    # the step's operands as views shaped for it: [S,B,H,hs,1] columns
    # (k, w) and [S,B,H,1,hs] rows (v, r)
    k, w = k[..., :, None], w[..., :, None]
    v, r = v[..., None, :], r[..., None, :]
    ys = []
    for t in range(S):
        kv = k[t] * v[t]                                           # [B,H,hs,hs]
        ys.append(torch.matmul(r[t], torch.addcmul(state, u, kv)))  # [B,H,1,hs]
        state = torch.addcmul(kv, w[t], state)
    return torch.stack(ys, dim=1).reshape(B_, S, H, hs), state


def time_loop_cost(S: int, B: int, H: int, hs: int,
                   backward: bool = False) -> dict:
    """What the op analysis (``launch.op_analysis.OpCounter``) counts for
    :func:`time_loop`'s eager op stream over S steps of B x H heads of
    size hs, f32: its forward exactly (13 ops a step: four selects, the
    product, two ``addcmul``, the ``matmul``'s five; six more around the
    loop; 5 N FLOPs a step, 2 N of them in the ``bmm``, and 4 (8 N + 7 n
    + m) bytes, N = B H hs^2, n = B H hs, m = H hs); its backward
    (autograd's, y's gradient alone) by terms fitted to its counts at S =
    8-64, its FLOPs and bytes within 1 % of them there and its ops within
    4 % (one op a step more or less with the batch;
    ``tests/test_torch_dryrun.py``).  The backward's S^2 terms are the
    selects' gradients: each step's writes a zero [S, B, H, hs] tensor
    and adds it up."""
    N, n, m = B * H * hs * hs, B * H * hs, H * hs
    if not backward:
        return {"ops": 13 * S + 6, "flops": 5.0 * N * S,
                "dot_flops": 2.0 * N * S,
                "bytes": 4.0 * S * (8 * N + 7 * n + m)}
    return {"ops": 33 * S - 7,
            "flops": 4.0 * n * S * S + 18.0 * N * S - 8.0 * N,
            "dot_flops": 4.0 * N * S,
            "bytes": 4.0 * (16 * n * S * S + 30 * N * S + 4 * n * S
                            + 6 * m * S - 19 * N - 8 * n)}


class _ModelledLoop(torch.autograd.Function):
    """:func:`time_loop` on fake tensors: outputs of its shapes and its
    :func:`time_loop_cost` reported to the op analyses
    (``kernels.report``, a modelled unit, no kernel), forward and
    backward; where a gradient is wanted, the storage autograd would keep
    for the backward (three [B,H,hs,hs] f32 tensors a step: the product,
    the bonus-mixed state and the state) held as one tensor, and the
    steps' outputs beside their stacked copy, so a trace's peak counts
    them; nothing computed."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        S, B_, H, hs = r.shape
        ctx.dims, ctx.shapes = (S, B_, H, hs), [
            x.shape for x in (r, k, v, w, u, state)]
        grad = any(ctx.needs_input_grad)
        cost = time_loop_cost(S, B_, H, hs)
        cost["ops"] -= 4 if grad else 3        # the empties below count
        _k.report("rwkv6_time_loop", cost)
        if grad:
            ctx.save_for_backward(r.new_empty((S, 3) + tuple(state.shape)))
        steps = r.new_empty((S, B_, H, hs))     # the outputs before stack
        y = r.new_empty((B_, S, H, hs))
        del steps
        return y, state.new_empty(state.shape)

    @staticmethod
    def backward(ctx, gy, gstate):
        need = ctx.needs_input_grad
        cost = time_loop_cost(*ctx.dims, backward=True)
        cost["ops"] -= sum(need)
        _k.report("rwkv6_time_loop_backward", cost)
        return tuple(gy.new_empty(shape) if n else None
                     for shape, n in zip(ctx.shapes, need))


def rwkv6_att_forward(params, x: torch.Tensor, cfg: ModelConfig,
                      state: torch.Tensor | None = None,
                      prev_x: torch.Tensor | None = None, group=None):
    """Time mixing.  x: [B,S,D].  Returns (out, (state, last_x)); ``state``
    [B,H,hs,hs] f32 is a new tensor, the one passed in is not written.
    Over a model ``group`` (x replicated) the rank's heads, their out
    summed over it."""
    H, hs = rwkv_dims(cfg, group)
    B_, S, d = x.shape
    f32 = torch.float32
    if prev_x is None:
        prev_x = torch.zeros((B_, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, prev_x)
    xw, xk, xv, xr, xg = _mix_inputs(params, x, sx)
    decay = _mine(copy_to_group(_decay_exponent(params, xw), group), cfg,
                  group)
    xk, xv, xr, xg = copy_all_to_group([xk, xv, xr, xg], group)

    # time-major [S,B,H,hs] so a step reads one contiguous slice
    def heads(t):
        return t.reshape(B_, S, H, hs).transpose(0, 1).to(f32).contiguous()

    r = heads(xr @ params["w_r"])
    k = heads(xk @ params["w_k"])
    v = heads(xv @ params["w_v"])
    g = F.silu(xg @ params["w_g"])
    w = heads(torch.exp(-torch.exp(decay)))
    u = _mine(params["u"], cfg, group).reshape(H, hs)[None, :, :, None]

    if state is None:
        state = torch.zeros((B_, H, hs, hs), dtype=f32, device=x.device)
    y, state = time_loop(r, k, v, w, u, state)
    y = _group_norm(y, _mine(params["ln_scale"], cfg, group), H).to(x.dtype)
    out = row_parallel(y * g, params["w_o"], group)
    return out, (state, x[:, -1, :])


def rwkv6_ffn_forward(params, x: torch.Tensor,
                      prev_x: torch.Tensor | None = None, group=None):
    """Channel mixing.  x: [B,S,D].  Returns (out, last_x); over a model
    ``group`` (x replicated) the rank's ff block, summed before the
    gate."""
    B_, S, d = x.shape
    if prev_x is None:
        prev_x = torch.zeros((B_, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, prev_x)
    dx = sx - x
    xk = x + dx * params["mu_k"]
    xr = x + dx * params["mu_r"]
    k = torch.square(F.relu(copy_to_group(xk, group) @ params["w_k"]))
    return (torch.sigmoid(xr @ params["w_r"])
            * row_parallel(k, params["w_v"], group), x[:, -1, :])


def rwkv6_init_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                     device=None, group=None) -> dict:
    """The decode state: the rank's heads of ``wkv`` over a model
    ``group``, the token-shift carries whole."""
    H, hs = rwkv_dims(cfg, group)
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
