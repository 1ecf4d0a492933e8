"""Sharding rules as data: parameter paths -> partition specs (mirrors
``repro/launch/sharding.py``).

A spec is a tuple with one entry a dimension: ``None`` (not split), an
axis name, or a tuple of axis names (the GFL server dim over the pod and
data axes) — the entries of the reference's ``PartitionSpec``, which
writes a one-axis tuple as the axis name.  The
reference's rules are megatron-style tensor parallelism over ``"model"``
(column-parallel in-projections, row-parallel out-projections,
vocab-parallel embeddings, expert-parallel MoE stacks); in GFL training
every leaf gains a leading server dim over the data (and pod) axes.  The
port places the server dim by these specs (a rank holds a block of
servers, :mod:`repro_torch.launch.mesh`) and, under ``client_parallel``,
the client dim; splitting a leaf over ``"model"`` (tensor parallelism) is
ROADMAP item 20c, and the mesh step refuses a model axis above 1 without
``client_parallel``.
"""
from __future__ import annotations

import re
from typing import Optional

from repro_torch.configs.base import ModelConfig


def _spec(*parts) -> tuple:
    return tuple(parts)


# (regex over the "/"-joined path, spec builder (model_axis) -> spec).
# First match wins; specs are for the UNstacked (no layer dim) leaf — the
# layer dim is inserted at position 0 for stacked blocks and the server dim
# in front of everything for GFL training.
_RULES: list = [
    # embeddings / head: vocab-parallel
    (r"embed/table$", lambda m: _spec(m, None)),
    (r"lm_head/w$", lambda m: _spec(None, m)),
    (r"dec_pos$", lambda m: _spec(None, None)),
    # attention (gqa + mla + whisper cross)
    (r"(attn|xattn)/w_(q|k|v)$", lambda m: _spec(None, m)),
    (r"(attn|xattn)/w_o$", lambda m: _spec(m, None)),
    (r"attn/w_(dq|dkv|kr)$", lambda m: _spec(None, None)),
    (r"attn/w_u(q|k|v)$", lambda m: _spec(None, m)),
    (r"attn/(q_norm|kv_norm)$", lambda m: _spec(None)),
    # dense mlp
    (r"(mlp|shared)/w_(gate|up|in)$", lambda m: _spec(None, m)),
    (r"(mlp|shared)/w_(down|out)$", lambda m: _spec(m, None)),
    (r"(mlp|shared)/b_in$", lambda m: _spec(m)),
    (r"(mlp|shared)/b_out$", lambda m: _spec(None)),
    # moe: routed experts expert-parallel over "model" when E divides it;
    # param_spec rewrites to ff-parallel when it does not (mixtral E=8)
    (r"moe/router$", lambda m: _spec(None, None)),
    (r"moe/w_(gate|up)$", lambda m: _spec(m, None, None)),
    (r"moe/w_down$", lambda m: _spec(m, None, None)),
    # mamba2
    (r"ssm/w_in$", lambda m: _spec(None, m)),
    (r"ssm/w_out$", lambda m: _spec(m, None)),
    (r"ssm/(conv_w|conv_b|dt_bias|A_log|D|norm_scale)$", lambda m: _spec()),
    # rwkv6
    (r"att/w_(r|k|v|g)$", lambda m: _spec(None, m)),
    (r"att/w_o$", lambda m: _spec(m, None)),
    (r"att/(mu_x|mu|maa_w1|maa_w2|w0|decay_w1|decay_w2|u|ln_scale)$",
     lambda m: _spec()),
    (r"ffn/w_k$", lambda m: _spec(None, m)),
    (r"ffn/w_v$", lambda m: _spec(m, None)),
    (r"ffn/(w_r|mu_k|mu_r)$", lambda m: _spec()),
    # norms and anything small: replicate
    (r".*", lambda m: _spec()),
]


def _leaf_is_stacked(path_str: str) -> bool:
    return bool(re.match(r"(blocks|dense_blocks|enc_blocks)/", path_str))


def param_spec(path_str: str, cfg: ModelConfig, *,
               model_axis: Optional[str] = "model",
               stacked: bool = False,
               server_axes: Optional[tuple] = None) -> tuple:
    """The spec of one param leaf.  ``model_axis=None`` -> replicated."""
    parts = None
    for pat, builder in _RULES:
        if re.search(pat, path_str):
            parts = list(builder(model_axis))
            break
    # moe expert-parallel fallback: shard ff dim when E doesn't divide axis
    if re.search(r"moe/w_(gate|up|down)$", path_str) and cfg.moe is not None \
            and model_axis is not None:
        if cfg.moe.num_experts % 16 != 0:
            if path_str.endswith("w_down"):
                parts = [None, model_axis, None]   # [E, F, D]
            else:
                parts = [None, None, model_axis]   # [E, D, F]
    if stacked and _leaf_is_stacked(path_str):
        parts = [None] + parts                      # layer dim
    if server_axes:
        saxes = tuple(server_axes)                  # GFL server dim
        parts = [saxes if len(saxes) > 1 else saxes[0]] + parts
    return tuple(parts)


def params_specs(paths, cfg: ModelConfig, *,
                 server_axes: Optional[tuple] = None,
                 model_axis: Optional[str] = "model") -> dict:
    """{path: spec} for the tree's leaf paths (stacked leaves carry their
    layer dim).  ``model_axis=None`` replicates every leaf over the model
    axis (the client-parallel small-model mode)."""
    return {ps: param_spec(ps, cfg, stacked=True, server_axes=server_axes,
                           model_axis=model_axis)
            for ps in paths}


# ---------------------------------------------------------------------------
# Cache / activation specs
# ---------------------------------------------------------------------------


def _data_axes(mesh):
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    return data_axes if len(data_axes) > 1 else data_axes[0]


def cache_specs(cfg: ModelConfig, mesh, *, shard_seq: bool = False) -> dict:
    """Specs for the decode cache.

    Default: batch over data(+pod) axes, trailing feature dim over model.
    shard_seq (long_500k, batch=1): sequence dim over data(+pod) instead.
    """
    da = _data_axes(mesh)
    b, s = (None, da) if shard_seq else (da, None)
    fam = cfg.family
    specs: dict = {"pos": ()}
    if fam in ("dense", "vlm", "moe"):
        if cfg.attention == "mla":
            specs["c_kv"] = (None, b, s, "model")
            specs["k_rope"] = (None, b, s, None)
        else:
            specs["k"] = (None, b, s, None, "model")
            specs["v"] = (None, b, s, None, "model")
    elif fam == "ssm":
        specs["wkv"] = (None, b, "model" if not shard_seq else None,
                        None, None)
        specs["att_x"] = (None, b, None)
        specs["ffn_x"] = (None, b, None)
        if shard_seq:  # batch=1: shard heads over model only
            specs["wkv"] = (None, None, "model", None, None)
            specs["att_x"] = (None, None, "model")
            specs["ffn_x"] = (None, None, "model")
    elif fam == "hybrid":
        specs["h"] = (None, b, "model", None, None)
        specs["conv"] = (None, b, None, "model")
        specs["attn_k"] = (None, b, s, None, "model")
        specs["attn_v"] = (None, b, s, None, "model")
    elif fam == "audio":
        specs["k"] = (None, b, s, None, "model")
        specs["v"] = (None, b, s, None, "model")
        specs["xk"] = (None, b, None, None, "model")
        specs["xv"] = (None, b, None, None, "model")
    return specs


def cache_shardings(cache, cfg: ModelConfig, mesh, *,
                    shard_seq: bool = False) -> dict:
    """{name: spec} for the entries of a decode cache."""
    specs = cache_specs(cfg, mesh, shard_seq=shard_seq)
    return {k: specs[k] for k in cache}


def batch_specs(cfg: ModelConfig, mesh, *, kind: str,
                gfl_train: bool = False,
                client_parallel: bool = False) -> dict:
    """Specs for input batches."""
    da = _data_axes(mesh)
    if gfl_train:
        # leading dims [P_servers, L, b, ...]; client-parallel mode spreads
        # the L clients over the idle model axis
        lead = (da, "model" if client_parallel else None, None)
    else:
        lead = (da,)
    specs = {"tokens": lead + (None,), "labels": lead + (None,)}
    if cfg.family == "vlm":
        specs["image_embeds"] = lead + (None, "model")
    if cfg.family == "audio":
        specs["frames"] = lead + (None, "model")
    return specs
