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
the client dim.  Serving splits each leaf over ``"model"`` by the same
specs (:func:`shard_leaf`, the collectives in
:mod:`repro_torch.models.parallel`) for every family, and so does
training (the train step runs each rank's blocks under the server dim).

Run-time layout of a split leaf.  A spec names the dimension; the rank
takes its block of it, but attention leaves split by whole heads
(:func:`gqa_heads`, :func:`mla_heads`): K/V heads are replicated over
the ranks that share them when the model axis is a multiple of their
count, and otherwise padded with zero heads (zero ``w_o`` rows), as GSPMD
pads the dims it cannot split evenly, so a padded head adds exactly 0.
Mamba2's packed in-projection ``ssm/w_in`` (z, x, B, C and dt side by
side) is held a segment at a time (:func:`mamba_ranges`): z and x by
whole heads, B and C by N / M state columns of each group, dt by heads;
its ``ssm/w_out`` splits by whole heads, and a head count (or a state
width) the group does not divide raises, naming the leaf.  RWKV-6's
time-mixing products split by whole heads padded as MLA's
(:func:`padded_heads`: ceil(H / M) heads a rank, zero heads last), so a
group that divides its width but not its heads (rwkv6-3b's 40 at 16)
runs.  The reference's ``cache_specs`` split the K/V cache's
head_dim over ``"model"``; the port's caches hold the rank's whole K/V
heads (and MLA's latent cache whole on every rank), and the Mamba2 and
RWKV-6 states the rank's heads, pads included (the token-shift carries
whole): a run-time layout, the specs stay the reference's.
:func:`unshard_leaf` puts the ranks' blocks back together (pads
dropped), and :func:`multiplicity` says how many ranks hold each block
(what a sum over the group counts once: the train step's clip and
telemetry norms).  :data:`READ_IN_PART` lists the
whole leaves a rank reads only in part (its heads' or channels'
entries), whose gradients the train step sums over the group.
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Optional

import torch

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
# Splitting leaves over the model group (tensor parallelism)
# ---------------------------------------------------------------------------


class Heads(NamedTuple):
    """Each rank's attention heads: global query (and K/V) head indices,
    -1 for a zero head that pads the split."""
    q: tuple
    kv: tuple


def gqa_heads(h: int, kv: int, M: int) -> Heads:
    """GQA's h query heads (G = h / kv a K/V head) over M ranks, each
    rank a run of consecutive query heads and the K/V heads they read:
    one K/V head shared by M / kv ranks where kv divides M and M / kv
    divides G; else kv / M K/V heads a rank, the K/V heads padded with
    zero heads (G zero query heads each) to a multiple of M first where
    M does not divide kv."""
    G = h // kv
    if kv % M and M % kv == 0 and G % (M // kv) == 0:
        r = M // kv
        gl = G // r
        return Heads(tuple(tuple((m // r) * G + (m % r) * gl + g
                                 for g in range(gl)) for m in range(M)),
                     tuple((m // r,) for m in range(M)))
    per = -(-kv // M)
    runs = [range(m * per, (m + 1) * per) for m in range(M)]
    return Heads(tuple(tuple(j * G + g if j < kv else -1 for j in run
                             for g in range(G)) for run in runs),
                 tuple(tuple(j if j < kv else -1 for j in run)
                       for run in runs))


def padded_heads(h: int, M: int) -> tuple:
    """h heads over M ranks, ceil(h / M) consecutive heads a rank, padded
    with zero heads (-1) to a multiple of M: the pads follow the last real
    head, so a rank holds a run of real heads and then its pads."""
    per = -(-h // M)
    return tuple(tuple(j if j < h else -1
                       for j in range(m * per, (m + 1) * per))
                 for m in range(M))


def mla_heads(h: int, M: int) -> Heads:
    """MLA's h heads over M ranks, padded with zero heads to a multiple of
    M; its latent cache is every rank's whole (``kv`` names no head)."""
    return Heads(padded_heads(h, M), ())


def rwkv_heads(cfg: ModelConfig) -> int:
    """RWKV-6's head count, d_model / head_size."""
    return cfg.d_model // cfg.rwkv.head_size


def heads(cfg: ModelConfig, M: int) -> Heads:
    """Each rank's heads at a model group of M: attention's, or RWKV-6's
    time-mixing heads (padded as MLA's, :func:`padded_heads`)."""
    if cfg.rwkv is not None:
        return Heads(padded_heads(rwkv_heads(cfg), M), ())
    if cfg.attention == "mla":
        return mla_heads(cfg.num_heads, M)
    return gqa_heads(cfg.num_heads, cfg.num_kv_heads, M)


def local_config(cfg: ModelConfig, M: int) -> ModelConfig:
    """The config the rank's attention runs with: its own head counts (at
    the global head dim); ``cfg`` itself at M = 1."""
    if M == 1 or cfg.attention not in ("gqa", "mla"):
        return cfg
    hd = heads(cfg, M)
    h = len(hd.q[0])
    return dataclasses.replace(cfg, num_heads=h,
                               num_kv_heads=len(hd.kv[0]) if hd.kv else h,
                               head_dim=cfg.resolved_head_dim)


# the attention leaves split by heads: (regex, which heads) -- the query
# heads, or GQA's K/V heads
_HEAD_LEAVES = ((r"attn/w_(k|v)$", "kv"),
                (r"attn/w_(q|o|uq|uk|uv)$", "q"))

# RWKV-6's time-mixing products, split by its heads (:func:`heads`)
_RWKV_HEAD_LEAVES = r"att/w_(r|k|v|g|o)$"


# the split leaves whose split dim is a run of heads of a fixed width
# (not padded): (regex, the width from the config)
_UNIT_LEAVES = ((r"ssm/w_out$", lambda cfg: cfg.ssm.headdim),)

# whole leaves a split model reads in part (its heads' or channels'
# entries of a per-channel leaf), so that a rank's gradient of each is
# its part's: the train step sums them over the model group
READ_IN_PART = (r"ssm/(conv_w|conv_b|dt_bias|A_log|D|norm_scale)$",
                r"att/(u|ln_scale)$")


def read_in_part(path: str, M: int) -> bool:
    """True for a whole leaf a split model (M > 1) reads in part."""
    return M > 1 and any(re.search(p, path) for p in READ_IN_PART)


def mamba_ranges(cfg: ModelConfig, M: int, m: int,
                 path: str = "ssm/w_in") -> dict:
    """Rank m's (start, stop) ranges, in order, of a Mamba2 layer's packed
    dims at a model group of M: ``"w_in"``'s columns (z and x by whole
    heads, B and C by N / M state columns of each of the G groups, dt by
    heads) and ``"conv"``'s channels (its x, B and C, the rank's conv
    input in that order).  Raises, naming ``path``, where M divides the
    heads or the state width not."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H, N, G = d_inner // s.headdim, s.state_dim, s.ngroups
    if H % M or N % M:
        raise ValueError(f"{path}: {H} heads and a state of {N} do not "
                         f"split over a model group of {M}")
    dl, nl, hl = d_inner // M, N // M, H // M

    def at(off, ranges):
        return [(off + a, off + b) for a, b in ranges]

    heads = [(m * dl, (m + 1) * dl)]
    states = [(g * N + m * nl, g * N + (m + 1) * nl) for g in range(G)]
    conv = heads + at(d_inner, states) + at(d_inner + G * N, states)
    dt = [(2 * d_inner + 2 * G * N + m * hl, 2 * d_inner + 2 * G * N
           + (m + 1) * hl)]
    return {"w_in": heads + at(d_inner, conv) + dt, "conv": conv}


def take(x: torch.Tensor, ranges, dim: int = -1) -> torch.Tensor:
    """``x``'s entries in ``ranges`` ((start, stop) pairs) of ``dim``,
    side by side: a view for one range, else a new tensor."""
    if len(ranges) == 1:
        a, b = ranges[0]
        return x.narrow(dim, a, b - a)
    return torch.cat([x.narrow(dim, a, b - a) for a, b in ranges], dim)


def _packed(path: str, cfg: ModelConfig, M: int, m: int):
    """Rank m's ranges of a leaf held a segment at a time, or None."""
    if re.search(r"ssm/w_in$", path) and cfg.ssm is not None:
        return mamba_ranges(cfg, M, m, path)["w_in"]
    return None


def _model_dim(path: str, cfg: ModelConfig) -> Optional[int]:
    spec = param_spec(path, cfg)
    return spec.index("model") if "model" in spec else None


def _head_set(path: str, cfg: ModelConfig, M: int):
    """(the rank's heads, heads in the leaf) of an attention or RWKV-6
    leaf split by heads, or None."""
    if cfg.rwkv is not None and re.search(_RWKV_HEAD_LEAVES, path):
        return heads(cfg, M).q, rwkv_heads(cfg)
    for pat, which in _HEAD_LEAVES:
        if re.search(pat, path) and cfg.attention in ("gqa", "mla"):
            hd = heads(cfg, M)
            if which == "kv" and cfg.attention == "gqa":
                return hd.kv, cfg.num_kv_heads
            if which == "q":
                return hd.q, cfg.num_heads
    return None


def local_shape(path: str, shape, cfg: ModelConfig, M: int) -> tuple:
    """The shape of a rank's block of the leaf at ``path`` (one layer, no
    server dim) of whole shape ``shape``, at a model group of M."""
    shape = tuple(shape)
    dim = _model_dim(path, cfg) if M > 1 else None
    if dim is None:
        return shape
    hs = _head_set(path, cfg, M)
    n = shape[dim]
    if hs is not None:
        width = n // hs[1]
        return shape[:dim] + (len(hs[0][0]) * width,) + shape[dim + 1:]
    packed = _packed(path, cfg, M, 0)
    if packed is not None:
        return shape[:dim] + (sum(b - a for a, b in packed),) \
            + shape[dim + 1:]
    for pat, unit in _UNIT_LEAVES:
        if re.search(pat, path) and (n // unit(cfg)) % M:
            raise ValueError(f"{path}: {n // unit(cfg)} heads do not split "
                             f"over a model group of {M}")
    if n % M:
        raise ValueError(f"{path}: dim {dim} of {n} does not split over a "
                         f"model group of {M}")
    return shape[:dim] + (n // M,) + shape[dim + 1:]


def shard_leaf(path: str, full: torch.Tensor, cfg: ModelConfig,
               group, lead: int = 0) -> torch.Tensor:
    """The rank's block of the whole leaf ``full`` at ``path`` (one
    layer, no server dim, behind ``lead`` leading dims that are not split:
    a layer stack's, a server dim's): the block of the dimension
    ``param_spec`` names (the MoE stacks' ff dim where their experts do
    not split), an attention leaf's whole heads (zeros for a padding
    head), ``ssm/w_in``'s segments (:func:`mamba_ranges`), a copy of its
    own so ``full`` can be freed; ``full`` itself where the leaf is
    replicated or ``group`` is None.  A vocab, ff, expert, head or state
    count the group does not divide raises, naming the leaf."""
    M = 1 if group is None else group.size
    dim = _model_dim(path, cfg) if M > 1 else None
    if dim is None:
        return full
    want = local_shape(path, full.shape[lead:], cfg, M)
    d = lead + dim
    packed = _packed(path, cfg, M, group.index)
    if packed is not None:
        return take(full, packed, d)
    hs = _head_set(path, cfg, M)
    if hs is None:
        per = want[dim]
        return full.narrow(d, group.index * per, per).clone()
    mine, n_heads = hs[0][group.index], hs[1]
    by_head = full.unflatten(d, (n_heads, full.shape[d] // n_heads))
    idx = torch.tensor([max(j, 0) for j in mine], device=full.device)
    out = by_head.index_select(d, idx)
    pad = [i for i, j in enumerate(mine) if j < 0]
    if pad:
        out.index_fill_(d, torch.tensor(pad, device=full.device), 0)
    return out.flatten(d, d + 1)


def unshard_leaf(path: str, blocks, cfg: ModelConfig, M: int,
                 lead: int = 0) -> torch.Tensor:
    """The whole leaf at ``path`` from the M ranks' blocks (in the model
    group's order, each behind ``lead`` leading dims): the inverse of
    :func:`shard_leaf`.  Split blocks side by side (``ssm/w_in``'s
    segments each back in its place); an attention leaf's
    real heads in their order, one copy of a shared K/V head, padding
    heads dropped; a replicated leaf's first block."""
    if len(blocks) != M:
        raise ValueError(f"{path}: {len(blocks)} blocks for a model group "
                         f"of {M}")
    dim = _model_dim(path, cfg) if M > 1 else None
    if dim is None:
        return blocks[0]
    d = lead + dim
    if _packed(path, cfg, M, 0) is not None:
        ranges = [_packed(path, cfg, M, m) for m in range(M)]
        shape = list(blocks[0].shape)
        shape[d] = sum(b - a for r in ranges for a, b in r)
        full = blocks[0].new_empty(shape)
        for r, block in zip(ranges, blocks):
            at = 0
            for a, b in r:
                full.narrow(d, a, b - a).copy_(block.narrow(d, at, b - a))
                at += b - a
        return full
    hs = _head_set(path, cfg, M)
    if hs is None:
        return torch.cat(list(blocks), d)
    heads, n_heads = hs
    width = blocks[0].shape[d] // len(heads[0])
    parts: dict = {}
    for mine, block in zip(heads, blocks):
        for i, j in enumerate(mine):
            if j >= 0 and j not in parts:
                parts[j] = block.narrow(d, i * width, width)
    return torch.cat([parts[j] for j in range(n_heads)], d)


def is_split(path: str, cfg: ModelConfig, M: int) -> bool:
    """True where a model group of M splits the leaf at ``path``."""
    return M > 1 and _model_dim(path, cfg) is not None


def multiplicity(path: str, cfg: ModelConfig, M: int) -> int:
    """How many ranks of a model group of M hold the same block of the
    leaf at ``path``: M for a replicated leaf, r for a K/V head shared by
    r ranks (:func:`gqa_heads`), 1 for every other split leaf.  The ranks
    holding one block are consecutive (indices ``m // r`` alike), so the
    first of them, ``index % multiplicity == 0``, counts it once."""
    if not is_split(path, cfg, M):
        return M
    hs = _head_set(path, cfg, M)
    return 1 if hs is None else hs[0].count(hs[0][0])


def stack_lead(path: str) -> int:
    """1 for a block-stack leaf (its layer dim ahead of the layer's
    shape in the reference's tree), else 0."""
    return int(_leaf_is_stacked(path))


def shard_tree(params: dict, cfg: ModelConfig, group) -> dict:
    """:func:`shard_leaf` over a ``Model``'s params tree (``embed``,
    ``lm_head``, ``blocks`` as a list of layers, nested dicts), each leaf
    by its reference path (``blocks/<part>/<leaf>``)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(layer, prefix) for layer in tree]
        return shard_leaf(prefix, tree, cfg, group)
    return walk(params, "")


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
