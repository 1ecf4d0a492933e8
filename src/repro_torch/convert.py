"""State carried across from the reference, through numpy.

The reference's ``GFLState``, ``LogisticProblem``, model param pytrees
(dense and MoE, GQA and MLA, RWKV-6 and the Mamba2 hybrid), importance-sampler ``ISState`` and
Dirichlet pools with their index tables hold jax arrays; a caller passes them here as numpy arrays (``np.asarray``,
``jax.tree.map(np.asarray, params)``) and gets the port's own types on
``device``, so both packages compute on the same numbers.  No jax is
imported on this side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.gfl import GFLState
from repro_torch.core.simulate import LogisticProblem


# the leaves the reference keeps in f32 whatever the param dtype is, by
# (part, leaf): Mamba2's A_log, RWKV-6's w0 and u
F32_LEAVES = {("ssm", "A_log"), ("att", "w0"), ("att", "u")}


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def gfl_state_from_numpy(params, step, device=None) -> GFLState:
    """GFLState from the reference's ``params`` [P, D] and ``step``."""
    return GFLState(_tensor(params, resolve_device(device)),
                    int(np.asarray(step)))


def problem_from_numpy(features, labels, rho, w_opt,
                       device=None) -> LogisticProblem:
    """LogisticProblem from the reference's arrays."""
    dev = resolve_device(device)
    return LogisticProblem(_tensor(features, dev), _tensor(labels, dev),
                           float(rho), _tensor(w_opt, dev))


def _model_tensor(x, shape, dtype: torch.dtype, name: str, device):
    x = np.asarray(x)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {x.shape}, expected {tuple(shape)}")
    if str(x.dtype) != str(dtype).replace("torch.", ""):
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if dtype == torch.bfloat16:
        # numpy has no bf16 of its own: carry the bits across as uint16
        t = torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(dtype)
    else:
        t = torch.from_numpy(np.array(x))        # a writable copy
    return t.to(device)


def _attn_shapes(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    if cfg.attention != "mla":
        hd = h * cfg.resolved_head_dim
        kvd = cfg.num_kv_heads * cfg.resolved_head_dim
        return {"w_q": (d, hd), "w_k": (d, kvd), "w_v": (d, kvd),
                "w_o": (hd, d)}
    m = cfg.mla
    dn, dr, dv, R = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    out = {"w_dkv": (d, R), "w_kr": (d, dr), "w_uk": (R, h * dn),
           "w_uv": (R, h * dv), "w_o": (h * dv, d), "kv_norm": (R,)}
    if m.q_lora_rank:
        out.update(w_dq=(d, m.q_lora_rank),
                   w_uq=(m.q_lora_rank, h * (dn + dr)),
                   q_norm=(m.q_lora_rank,))
    else:
        out["w_q"] = (d, h * (dn + dr))
    return out


def _swiglu_shapes(d: int, ff: int) -> dict:
    return {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}


def _mamba_shapes(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H, N, G = d_inner // s.headdim, s.state_dim, s.ngroups
    conv_ch = d_inner + 2 * G * N
    return {"w_in": (d, 2 * d_inner + 2 * G * N + H),
            "conv_w": (s.conv_dim, conv_ch), "conv_b": (conv_ch,),
            "dt_bias": (H,), "A_log": (H,), "D": (H,),
            "norm_scale": (d_inner,), "w_out": (d_inner, d)}


def _rwkv_shapes(cfg: ModelConfig) -> dict:
    r = cfg.rwkv
    d, dff = cfg.d_model, cfg.d_ff
    att = {"mu_x": (d,), "mu": (5, d), "maa_w1": (d, 5 * r.mix_lora),
           "maa_w2": (5, r.mix_lora, d), "w0": (d,),
           "decay_w1": (d, r.decay_lora), "decay_w2": (r.decay_lora, d),
           "u": (d,), "ln_scale": (d,)}
    att.update({w: (d, d) for w in ("w_r", "w_k", "w_v", "w_g", "w_o")})
    return {"ln1": {"scale": (d,)}, "att": att, "ln2": {"scale": (d,)},
            "ffn": {"mu_k": (d,), "mu_r": (d,), "w_k": (d, dff),
                    "w_v": (dff, d), "w_r": (d, d)}}


def _shared_attn_shapes(cfg: ModelConfig) -> dict:
    """The hybrid family's shared attention + SwiGLU block."""
    d = cfg.d_model
    return {"ln": {"scale": (d,)}, "attn": _attn_shapes(cfg),
            "ln2": {"scale": (d,)}, "mlp": _swiglu_shapes(d, cfg.d_ff)}


def _block_shapes(cfg: ModelConfig, *, moe: bool, d_ff: int) -> dict:
    """{(part, leaf[, leaf]): shape} of one layer of a block stack."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return dict(_leaves(_rwkv_shapes(cfg)))
    if cfg.family == "hybrid":
        return dict(_leaves({"ln": {"scale": (d,)},
                             "ssm": _mamba_shapes(cfg)}))
    tree = {"ln1": {"scale": (d,)}, "attn": _attn_shapes(cfg),
            "ln2": {"scale": (d,)}}
    if moe:
        m = cfg.moe
        dff = m.expert_d_ff or cfg.d_ff
        E = m.num_experts
        tree["moe"] = {"router": (d, E), "w_gate": (E, d, dff),
                       "w_up": (E, d, dff), "w_down": (E, dff, d)}
        if m.num_shared_experts:
            tree["moe"]["shared"] = _swiglu_shapes(
                d, dff * m.num_shared_experts)
    else:
        tree["mlp"] = _swiglu_shapes(d, d_ff)
    return dict(_leaves(tree))


def _leaves(tree, prefix=()):
    """((path, leaf)) of a nested dict, in its order."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = value
    return out


def _leaf_dtype(path: tuple, dt: torch.dtype) -> torch.dtype:
    return torch.float32 if path[-2:] in F32_LEAVES else dt


def _stack_layers(stack, shapes: dict, n: int, dt, where: str, dev) -> list:
    """One nested dict per layer of a reference block stack (leaves
    [n, ...]), each tensor checked and its own copy, not a view."""
    got = {path for path, _ in _leaves(stack)}
    if got != set(shapes):
        raise ValueError(f"{where}: leaves {sorted(got)} do not match "
                         f"{sorted(shapes)}")
    leaves = dict(_leaves(stack))
    stacked = {path: _model_tensor(leaves[path], (n, *shape),
                                   _leaf_dtype(path, dt),
                                   ".".join((where,) + path), dev)
               for path, shape in shapes.items()}
    return [_nest({path: t[i].clone() for path, t in stacked.items()})
            for i in range(n)]


def model_params_from_numpy(tree: dict, cfg: ModelConfig,
                            device=None) -> dict:
    """The params of ``repro_torch.models.model.Model(cfg, params)`` from
    the reference's param pytree (numpy leaves) of a dense or MoE model
    with GQA or MLA attention, an RWKV-6 model (``blocks`` of ``{ln1, att,
    ln2, ffn}``) or a hybrid one (``blocks`` of ``{ln, ssm}`` and the
    top-level ``shared_attn``).  The stacked ``[n_layers, ...]`` block
    arrays are split into one dict per layer, the ``dense_blocks`` of a
    MoE model with leading dense layers first; every tensor is checked for
    shape and dtype (``cfg.param_dtype``, f32 for ``F32_LEAVES``)."""
    from repro_torch.models.model import check_supported, padded_vocab
    check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    d, vocab = cfg.d_model, padded_vocab(cfg)
    expect = {("embed", "table"): (vocab, d), ("final_norm", "scale"): (d,)}
    if not cfg.tie_embeddings:
        expect[("lm_head", "w")] = (d, vocab)
    if cfg.family == "hybrid":
        expect.update({("shared_attn",) + path: shape for path, shape
                       in _leaves(_shared_attn_shapes(cfg))})
    stacks = {"blocks": (cfg.num_layers, _block_shapes(
        cfg, moe=cfg.moe is not None, d_ff=cfg.d_ff))}
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        nd = cfg.moe.first_dense_layers
        stacks = {"dense_blocks": (nd, _block_shapes(
            cfg, moe=False, d_ff=cfg.moe.first_dense_d_ff or cfg.d_ff)),
                  "blocks": (cfg.num_layers - nd, stacks["blocks"][1])}
    parts = {path[0] for path in expect}
    if set(tree) != parts | set(stacks):
        raise ValueError(f"param tree keys {sorted(tree)} do not match "
                         f"{cfg.name}")
    leaves = {(part,) + path: leaf for part in parts
              for path, leaf in _leaves(tree[part])}
    if set(leaves) != set(expect):
        raise ValueError(f"leaves {sorted(leaves)} do not match "
                         f"{sorted(expect)}")
    params = _nest({path: _model_tensor(leaves[path], shape,
                                        _leaf_dtype(path, dt),
                                        ".".join(path), dev)
                    for path, shape in expect.items()})
    params["blocks"] = [
        layer for name, (n, shapes) in stacks.items()
        for layer in _stack_layers(tree[name], shapes, n, dt, name, dev)]
    return params


def is_state_from_numpy(norm_est, counts, device=None):
    """The importance sampler's state from the reference's ``ISState``
    (``norm_est`` [P, K] f32, ``counts`` [P, K] int32)."""
    from repro_torch.core.sampling import ISState
    norm_est, counts = np.asarray(norm_est), np.asarray(counts)
    if norm_est.shape != counts.shape or norm_est.ndim != 2:
        raise ValueError(f"IS state shapes {norm_est.shape} and "
                         f"{counts.shape}: expected two equal [P, K]")
    dev = resolve_device(device)
    return ISState(_tensor(norm_est, dev),
                   torch.tensor(counts.astype(np.int32), device=dev))


def dirichlet_population_from_numpy(pool_h, pool_g, index, *,
                                    alpha: float = 0.5, rho: float = 0.01,
                                    device=None):
    """A :class:`DirichletPopulation` on the reference's pool ([n, M],
    [n]) and its index table ``index`` [P, K, N], taken as it is (no new
    split)."""
    from repro_torch.core.population.population import DirichletPopulation
    dev = resolve_device(device)
    index = np.asarray(index)
    if index.ndim != 3:
        raise ValueError(f"index table of shape {index.shape}: expected "
                         "[P, K, N]")
    return DirichletPopulation.from_index(
        _tensor(pool_h, dev), _tensor(pool_g, dev),
        torch.tensor(index.astype(np.int64), device=dev), alpha=alpha,
        rho=rho)
