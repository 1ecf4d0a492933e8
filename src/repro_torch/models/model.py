"""The dense and MoE model families, with GQA or MLA attention, the ssm
family (RWKV-6) and the hybrid one (a Mamba2 stack and one shared
attention block), as an ``nn.Module`` (mirrors the dense, moe, ssm and
hybrid paths of ``repro/models/model.py``).

    model  = Model.init(cfg, generator)          # or Model(cfg, params)
    logits = model.forward(tokens)               # [B, S, V]; model.last_aux
    logits, cache = model.prefill(tokens)        # fills the cache
    logits, cache = model.decode_step(tokens, cache)

Parameters keep the reference's names and ``[in, out]`` layout; the
reference's stacked ``[n_layers, ...]`` block arrays are one entry of
``blocks`` per layer here, its ``dense_blocks`` (DeepSeek's leading dense
layers) first, so a reference init carries across as a copy
(``repro_torch.convert.model_params_from_numpy``) and cache layer i belongs
to block i.  A block's FFN is SwiGLU (``mlp``) or the MoE layer (``moe``).
An ssm block is ``{ln1, att, ln2, ffn}`` (RWKV-6 time and channel mixing),
a hybrid block ``{ln, ssm}`` (Mamba2); the hybrid family's ``shared_attn``
(``{ln, attn, ln2, mlp}``, one set of weights) runs after every
``hybrid_attn_every`` Mamba2 layers (:func:`_hybrid_groups`), each
application with its own KV cache slot, its decode attention through K8.
Logits cover the vocab padded to a multiple of 128, as the reference's do.
Prefill and decode update the cache in place.  The vlm and audio families
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rwkv, ssm

# the families still to port and their ROADMAP items (queue 1, slice 7)
_PENDING_FAMILIES = {
    "vlm": "item 19d (VLM inputs)",
    "audio": "item 19d (audio encoder-decoder)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Megatron-style padding of the vocab to a multiple of 128."""
    return -(-cfg.vocab_size // 128) * 128


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family in _PENDING_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} is not ported yet: ROADMAP "
            f"queue 1, {_PENDING_FAMILIES[cfg.family]}")
    plain = cfg.moe is None and cfg.mla is None
    if cfg.family == "ssm":
        ok = plain and cfg.attention == "none" and cfg.rwkv is not None
    elif cfg.family == "hybrid":
        ok = (plain and cfg.attention == "gqa" and cfg.ssm is not None
              and cfg.hybrid_attn_every > 0)
    else:
        ok = (cfg.family in ("dense", "moe")
              and cfg.attention in ("gqa", "mla")
              and (cfg.family == "moe") == (cfg.moe is not None)
              and (cfg.attention == "mla") == (cfg.mla is not None))
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} attention={cfg.attention!r} "
            f"moe={cfg.moe is not None} mla={cfg.mla is not None} "
            f"rwkv={cfg.rwkv is not None} ssm={cfg.ssm is not None} "
            f"hybrid_attn_every={cfg.hybrid_attn_every}: the port runs the "
            "dense and moe families with gqa or mla attention, ssm with rwkv "
            "and attention none, and hybrid with ssm, gqa attention and "
            "hybrid_attn_every > 0")


def _params(tree: dict) -> nn.ParameterDict:
    """A param subtree as a ParameterDict, nested dicts (the MoE layer's
    ``shared`` experts) as nested ones."""
    return nn.ParameterDict({
        name: _params(t) if isinstance(t, dict)
        else nn.Parameter(t, requires_grad=False)
        for name, t in tree.items()})


def _attn(bp, h, positions, cfg: ModelConfig, *, return_kv: bool = False):
    """The block's attention: MLA or GQA.  ``return_kv`` also returns what
    the cache keeps (c_kv and k_rope, or the roped K and the V)."""
    if cfg.attention == "mla":
        return attn.mla_forward(bp["attn"], h, positions, cfg,
                                return_kv=return_kv)
    return attn.gqa_forward(bp["attn"], h, positions, cfg,
                            return_kv=return_kv)


def _ffn(bp, h, cfg: ModelConfig):
    """The block's FFN: (out, router aux), the aux None for SwiGLU."""
    if "moe" in bp:
        return moe.moe_forward(bp["moe"], h, cfg)
    return layers.swiglu(bp["mlp"], h), None


def _mamba_block(bp, x, cfg: ModelConfig):
    h = layers.rms_norm(bp["ln"], x, cfg.norm_eps)
    out, state = ssm.mamba2_forward(bp["ssm"], h, cfg)
    return x + out, state


def _rwkv_block(bp, x, cfg: ModelConfig, state=None, att_x=None,
                ffn_x=None):
    h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
    out, (new_state, new_att_x) = rwkv.rwkv6_att_forward(
        bp["att"], h, cfg, state=state, prev_x=att_x)
    x = x + out
    h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
    out, new_ffn_x = rwkv.rwkv6_ffn_forward(bp["ffn"], h, prev_x=ffn_x)
    return x + out, (new_state, new_att_x, new_ffn_x)


def _store_rwkv(cache: dict, i: int, state) -> None:
    """Write layer i's (wkv, att_x, ffn_x) into the cache, in place."""
    for name, t in zip(("wkv", "att_x", "ffn_x"), state):
        cache[name][i].copy_(t)


def _hybrid_groups(cfg: ModelConfig):
    """Static (start, end, has_attn) layer groups for the zamba2 schedule:
    shared attention fires after every `hybrid_attn_every` mamba layers."""
    every = cfg.hybrid_attn_every
    L = cfg.num_layers
    groups = []
    i = 0
    while i < L:
        j = min(i + every, L)
        groups.append((i, j, j - i == every))
        i = j
    return groups


class Model(nn.Module):
    """Pre-norm GQA / MLA transformer with SwiGLU or MoE FFNs (yi, smollm,
    phi3, minicpm3; mixtral, deepseek-v2-lite), an RWKV-6 stack (rwkv6) or
    a Mamba2 stack with a shared attention block (zamba2)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.padded_vocab = padded_vocab(cfg)
        self.embed = _params(params["embed"])
        self.final_norm = _params(params["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _params(params["lm_head"]))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({part: _params(tree) for part, tree in bp.items()})
            for bp in params["blocks"])
        self.shared_attn = (
            nn.ModuleDict({part: _params(tree) for part, tree
                           in params["shared_attn"].items()})
            if cfg.family == "hybrid" else None)
        self.last_aux = None        # the router aux of the last forward

    # ------------------------------------------------------------- init ---

    @classmethod
    def init(cls, cfg: ModelConfig, generator: torch.Generator) -> "Model":
        """Random weights from ``generator``, on its device: the reference's
        shapes and distributions (its threefry bits are not reproduced)."""
        check_supported(cfg)
        dt = _dtype(cfg)
        dev = generator.device
        vocab = padded_vocab(cfg)
        params = {
            "embed": layers.embed_init(generator, vocab, cfg.d_model, dt),
            "final_norm": layers.rms_norm_init(cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.lm_head_init(generator, cfg.d_model,
                                                    vocab, dt)
        if cfg.family == "ssm":
            params["blocks"] = [cls._rwkv_block_init(cfg, generator)
                                for _ in range(cfg.num_layers)]
        elif cfg.family == "hybrid":
            params["blocks"] = [cls._mamba_block_init(cfg, generator)
                                for _ in range(cfg.num_layers)]
            params["shared_attn"] = {
                "ln": layers.rms_norm_init(cfg.d_model, dt, dev),
                "attn": attn.gqa_init(generator, cfg, dt),
                "ln2": layers.rms_norm_init(cfg.d_model, dt, dev),
                "mlp": layers.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                          dt),
            }
        elif cfg.moe is None:
            params["blocks"] = [cls._dense_block_init(cfg, generator)
                                for _ in range(cfg.num_layers)]
        else:
            nd = cfg.moe.first_dense_layers
            d_ff = cfg.moe.first_dense_d_ff or cfg.d_ff
            params["blocks"] = (
                [cls._dense_block_init(cfg, generator, d_ff)
                 for _ in range(nd)]
                + [cls._moe_block_init(cfg, generator)
                   for _ in range(cfg.num_layers - nd)])
        return cls(cfg, params)

    @staticmethod
    def _attn_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
        a_init = attn.mla_init if cfg.attention == "mla" else attn.gqa_init
        return a_init(gen, cfg, _dtype(cfg))

    @classmethod
    def _dense_block_init(cls, cfg: ModelConfig, gen: torch.Generator,
                          d_ff: int = 0) -> dict:
        dt = _dtype(cfg)
        return {
            "ln1": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "attn": cls._attn_init(cfg, gen),
            "ln2": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "mlp": layers.swiglu_init(gen, cfg.d_model, d_ff or cfg.d_ff, dt),
        }

    @classmethod
    def _moe_block_init(cls, cfg: ModelConfig, gen: torch.Generator) -> dict:
        dt = _dtype(cfg)
        return {
            "ln1": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "attn": cls._attn_init(cfg, gen),
            "ln2": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "moe": moe.moe_init(gen, cfg, dt),
        }

    @staticmethod
    def _mamba_block_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
        dt = _dtype(cfg)
        return {
            "ln": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "ssm": ssm.mamba2_init(gen, cfg, dt),
        }

    @staticmethod
    def _rwkv_block_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
        dt = _dtype(cfg)
        return {
            "ln1": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "att": rwkv.rwkv6_att_init(gen, cfg, dt),
            "ln2": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "ffn": rwkv.rwkv6_ffn_init(gen, cfg, dt),
        }

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ---------------------------------------------------------- forward ---

    def _embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(self.embed, tokens)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (the train / prefill compute); the
        router aux summed over the MoE layers is kept as ``last_aux`` (a
        zero without MoE layers)."""
        cfg = self.cfg
        x = self._embed_inputs(tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "ssm":
            for bp in self.blocks:
                x, _ = _rwkv_block(bp, x, cfg)
        elif cfg.family == "hybrid":
            for g0, g1, has_attn in _hybrid_groups(cfg):
                for bp in self.blocks[g0:g1]:
                    x, _ = _mamba_block(bp, x, cfg)
                if has_attn:
                    x = self._shared_block(x, positions)[0]
        else:
            for bp in self.blocks:
                h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
                x = x + _attn(bp, h, positions, cfg)
                h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
                out, a = _ffn(bp, h, cfg)
                x = x + out
                if a is not None:
                    aux = aux + a
        self.last_aux = aux
        x = layers.rms_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)

    def _shared_block(self, x, positions):
        """The hybrid family's shared attention + SwiGLU block; also returns
        the roped K and the V its attention made, [B,S,KV,Dh] each."""
        cfg, sh = self.cfg, self.shared_attn
        h = layers.rms_norm(sh["ln"], x, cfg.norm_eps)
        out, k, v = attn.gqa_forward(sh["attn"], h, positions, cfg,
                                     return_kv=True)
        x = x + out
        h = layers.rms_norm(sh["ln2"], x, cfg.norm_eps)
        return x + layers.swiglu(sh["mlp"], h), k, v

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return layers.unembed(self.embed, x)
        return layers.lm_head(self.lm_head, x)

    # ------------------------------------------------------------ cache ---

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        L = cfg.num_layers
        if cfg.family == "ssm":
            return rwkv.rwkv6_init_cache(cfg, batch_size, L, dt, dev)
        if cfg.family == "hybrid":
            c = ssm.mamba2_init_cache(cfg, batch_size, L, dt, dev)
            kvc = attn.gqa_init_cache(cfg, batch_size, cache_len,
                                      L // cfg.hybrid_attn_every, dt, dev)
            c["attn_k"], c["attn_v"], c["pos"] = kvc["k"], kvc["v"], kvc["pos"]
            return c
        init = (attn.mla_init_cache if cfg.attention == "mla"
                else attn.gqa_init_cache)
        return init(cfg, batch_size, cache_len, L, dt, dev)

    # ----------------------------------------------------------- decode ---

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict):
        """One token for every sequence.  tokens: [B] int.  Returns
        (logits [B, V], cache) with the cache advanced in place."""
        cfg = self.cfg
        x = layers.embed(self.embed, tokens[:, None])          # [B,1,D]
        pos = cache["pos"]
        if cfg.family == "ssm":
            x = self._decode_rwkv(x, cache)
        elif cfg.family == "hybrid":
            x = self._decode_hybrid(x, cache)
        else:
            x = self._decode_dense(x, cache)
        cache["pos"] = pos + 1
        x = layers.rms_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)[:, 0, :], cache

    def _decode_dense(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        pos = cache["pos"]
        if self.cfg.attention == "mla":
            c0, c1 = cache["c_kv"], cache["k_rope"]
            slot = attn.mla_decode_slot(pos, c0.shape[2])
            nvalid = None
        else:
            c0, c1 = cache["k"], cache["v"]
            slot, nvalid = attn.gqa_decode_slots(pos, c0.shape[2])
        for i, bp in enumerate(self.blocks):
            x = self._dense_decode_block(bp, x, c0[i], c1[i], pos, slot,
                                         nvalid)
        return x

    def _decode_rwkv(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        cfg = self.cfg
        for i, bp in enumerate(self.blocks):
            x, state = _rwkv_block(
                bp, x, cfg, state=cache["wkv"][i], att_x=cache["att_x"][i],
                ffn_x=cache["ffn_x"][i])
            _store_rwkv(cache, i, state)
        return x

    def _decode_hybrid(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """Mamba2 steps with their h and conv window advanced in place; the
        shared block's a-th application writes KV slot a at the step's ring
        slot, its attention through K8."""
        cfg, sh = self.cfg, self.shared_attn
        pos = cache["pos"]
        slot, nvalid = attn.gqa_decode_slots(pos, cache["attn_k"].shape[2])
        a = 0
        for g0, g1, has_attn in _hybrid_groups(cfg):
            for i in range(g0, g1):
                bp = self.blocks[i]
                h = layers.rms_norm(bp["ln"], x, cfg.norm_eps)
                x = x + ssm.mamba2_decode(bp["ssm"], h, cache["h"][i],
                                          cache["conv"][i], cfg)
            if has_attn:
                h = layers.rms_norm(sh["ln"], x, cfg.norm_eps)
                x = x + attn.gqa_decode(sh["attn"], h, cache["attn_k"][a],
                                        cache["attn_v"][a], pos, slot,
                                        nvalid, cfg)
                h = layers.rms_norm(sh["ln2"], x, cfg.norm_eps)
                x = x + layers.swiglu(sh["mlp"], h)
                a += 1
        return x

    def _dense_decode_block(self, bp, x, cache_0, cache_1, pos, slot,
                            nvalid):
        """One block of a decode step; its caches (c_kv and k_rope, or K
        and V) are written in place at ``slot``."""
        cfg = self.cfg
        h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
        if cfg.attention == "mla":
            out = attn.mla_decode(bp["attn"], h, cache_0, cache_1, pos, slot,
                                  cfg)
        else:
            out = attn.gqa_decode(bp["attn"], h, cache_0, cache_1, pos,
                                  slot, nvalid, cfg)
        x = x + out
        h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
        return x + _ffn(bp, h, cfg)[0]

    # ---------------------------------------------------------- prefill ---

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int = 0):
        """Run the prompt [B, S], build the decode cache, return the last
        position's logits [B, V] and the cache.

        max_len: cache capacity (>= prompt + expected decode tokens),
        defaults to prompt + 64; a sliding-window arch caps it at the
        window (a ring)."""
        cfg = self.cfg
        x = self._embed_inputs(tokens)
        B, S, _ = x.shape
        cache = self.init_cache(B, max_len or S + 64)
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.family == "ssm":
            x = self._prefill_rwkv(x, cache)
        elif cfg.family == "hybrid":
            x = self._prefill_hybrid(x, positions, cache)
        else:
            x, cache = self._prefill_dense(x, positions, cache)
        cache["pos"].fill_(S)
        x = layers.rms_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x[:, -1:, :])[:, 0, :], cache

    @staticmethod
    def _fill_ring(cache_kv: torch.Tensor, k: torch.Tensor) -> None:
        """Write a whole prefill sequence into a (possibly ring) cache, in
        place.  cache_kv: [B,C,KV,Dh]; k: [B,S,KV,Dh].  Token t lands in
        slot t % C."""
        C = cache_kv.shape[1]
        S = k.shape[1]
        if S >= C:
            cache_kv.copy_(torch.roll(k[:, S - C:], (S - C) % C, dims=1))
        else:
            cache_kv[:, :S].copy_(k)

    def _prefill_dense(self, x, positions, cache):
        cfg = self.cfg
        mla = cfg.attention == "mla"
        S = x.shape[1]
        for i, bp in enumerate(self.blocks):
            h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
            out, c0, c1 = _attn(bp, h, positions, cfg, return_kv=True)
            if mla:         # the latent cache's first S slots
                cache["c_kv"][i, :, :S].copy_(c0)
                cache["k_rope"][i, :, :S].copy_(c1)
            else:
                self._fill_ring(cache["k"][i], c0)
                self._fill_ring(cache["v"][i], c1)
            x = x + out
            h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
            x = x + _ffn(bp, h, cfg)[0]
        return x, cache

    def _prefill_rwkv(self, x, cache):
        for i, bp in enumerate(self.blocks):
            x, state = _rwkv_block(bp, x, self.cfg)
            _store_rwkv(cache, i, state)
        return x

    def _prefill_hybrid(self, x, positions, cache):
        a = 0
        for g0, g1, has_attn in _hybrid_groups(self.cfg):
            for i in range(g0, g1):
                x, st = _mamba_block(self.blocks[i], x, self.cfg)
                cache["h"][i].copy_(st["h"])
                cache["conv"][i].copy_(st["conv"])
            if has_attn:
                x, k, v = self._shared_block(x, positions)
                self._fill_ring(cache["attn_k"][a], k)
                self._fill_ring(cache["attn_v"][a], v)
                a += 1
        return x
