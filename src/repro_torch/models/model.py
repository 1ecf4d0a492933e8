"""The dense and MoE model families, with GQA or MLA attention, as an
``nn.Module`` (mirrors the dense / moe paths of ``repro/models/model.py``).

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
Logits cover the vocab padded to a multiple of 128, as the reference's do.
Prefill and decode update the cache in place.  The ssm, hybrid, vlm and
audio families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe

# the families still to port and their ROADMAP items (queue 1, slice 7)
_PENDING_FAMILIES = {
    "ssm": "item 19c (models/ssm.py, models/rwkv.py)",
    "hybrid": "item 19c (models/ssm.py, models/rwkv.py)",
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
    if (cfg.family not in ("dense", "moe")
            or cfg.attention not in ("gqa", "mla")
            or (cfg.family == "moe") != (cfg.moe is not None)
            or (cfg.attention == "mla") != (cfg.mla is not None)):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} attention={cfg.attention!r} "
            f"moe={cfg.moe is not None} mla={cfg.mla is not None}: the port "
            "runs the dense and moe families with gqa or mla attention")


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


class Model(nn.Module):
    """Pre-norm GQA / MLA transformer with SwiGLU or MoE FFNs (yi, smollm,
    phi3, minicpm3; mixtral, deepseek-v2-lite)."""

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
        if cfg.moe is None:
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

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ---------------------------------------------------------- forward ---

    def _embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(self.embed, tokens)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (the train / prefill compute); the
        router aux summed over the MoE layers is kept as ``last_aux``."""
        cfg = self.cfg
        x = self._embed_inputs(tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
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

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return layers.unembed(self.embed, x)
        return layers.lm_head(self.lm_head, x)

    # ------------------------------------------------------------ cache ---

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        init = (attn.mla_init_cache if self.cfg.attention == "mla"
                else attn.gqa_init_cache)
        return init(self.cfg, batch_size, cache_len, self.cfg.num_layers,
                    _dtype(self.cfg), self.device)

    # ----------------------------------------------------------- decode ---

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict):
        """One token for every sequence.  tokens: [B] int.  Returns
        (logits [B, V], cache) with the cache advanced in place."""
        cfg = self.cfg
        x = layers.embed(self.embed, tokens[:, None])          # [B,1,D]
        pos = cache["pos"]
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
