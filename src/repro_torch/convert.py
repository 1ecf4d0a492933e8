"""State carried across from the reference, through numpy.

The reference's ``GFLState``, ``LogisticProblem``, model param pytrees,
importance-sampler ``ISState`` and Dirichlet pools with their index tables
hold jax arrays; a caller passes them here as numpy arrays (``np.asarray``,
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


def model_params_from_numpy(tree: dict, cfg: ModelConfig,
                            device=None) -> dict:
    """The params of ``repro_torch.models.model.Model(cfg, params)`` from
    the reference's dense-GQA param pytree (numpy leaves).  The stacked
    ``[n_layers, ...]`` block arrays are split into one dict per layer;
    every tensor is checked for shape and dtype (``cfg.param_dtype``)."""
    from repro_torch.models.model import check_supported, padded_vocab
    check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.num_layers
    hd = cfg.num_heads * cfg.resolved_head_dim
    kvd = cfg.num_kv_heads * cfg.resolved_head_dim
    vocab = padded_vocab(cfg)
    expect = {("embed", "table"): (vocab, d), ("final_norm", "scale"): (d,)}
    if not cfg.tie_embeddings:
        expect[("lm_head", "w")] = (d, vocab)
    block = {("ln1", "scale"): (d,), ("attn", "w_q"): (d, hd),
             ("attn", "w_k"): (d, kvd), ("attn", "w_v"): (d, kvd),
             ("attn", "w_o"): (hd, d), ("ln2", "scale"): (d,),
             ("mlp", "w_gate"): (d, ff), ("mlp", "w_up"): (d, ff),
             ("mlp", "w_down"): (ff, d)}
    if set(tree) != {part for part, _ in expect} | {"blocks"}:
        raise ValueError(f"param tree keys {sorted(tree)} do not match "
                         f"{cfg.name}")
    params: dict = {}
    for (part, leaf), shape in expect.items():
        params.setdefault(part, {})[leaf] = _model_tensor(
            tree[part][leaf], shape, dt, f"{part}.{leaf}", dev)
    stacked = {(part, leaf): _model_tensor(
        tree["blocks"][part][leaf], (n, *shape), dt,
        f"blocks.{part}.{leaf}", dev) for (part, leaf), shape in block.items()}
    # one tensor per layer, not views of the stack
    params["blocks"] = [
        {part: {leaf: stacked[(part, leaf)][i].clone()
                for (p, leaf) in block if p == part}
         for part in ("ln1", "attn", "ln2", "mlp")}
        for i in range(n)]
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
