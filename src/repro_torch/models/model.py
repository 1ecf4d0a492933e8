"""The dense GQA model family as an ``nn.Module`` (mirrors the dense path of
``repro/models/model.py``).

    model  = Model.init(cfg, generator)          # or Model(cfg, params)
    logits = model.forward(tokens)               # [B, S, V]
    logits, cache = model.prefill(tokens)        # fills the ring cache
    logits, cache = model.decode_step(tokens, cache)

Parameters keep the reference's names and ``[in, out]`` layout; the
reference's stacked ``[n_layers, ...]`` block arrays are one entry of
``blocks`` per layer here, so a reference init carries across as a copy
(``repro_torch.convert.model_params_from_numpy``).  Logits cover the vocab
padded to a multiple of 128, as the reference's do.  Prefill and decode
update the cache in place.  Families other than dense GQA without MoE
raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Megatron-style padding of the vocab to a multiple of 128."""
    return -(-cfg.vocab_size // 128) * 128


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "gqa" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} attention={cfg.attention!r} "
            f"moe={cfg.moe is not None} is not ported yet; the port runs the "
            "dense GQA family (ROADMAP queue 1, slice 7)")


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                             for name, t in tree.items()})


def _dense_block(bp, x, positions, cfg: ModelConfig):
    h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(bp["attn"], h, positions, cfg)
    h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
    return x + layers.swiglu(bp["mlp"], h)


class Model(nn.Module):
    """Dense pre-norm GQA + SwiGLU transformer (yi, smollm, phi3)."""

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
            nn.ModuleDict({part: _params(bp[part]) for part in
                           ("ln1", "attn", "ln2", "mlp")})
            for bp in params["blocks"])

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
        params["blocks"] = [cls._dense_block_init(cfg, generator)
                            for _ in range(cfg.num_layers)]
        return cls(cfg, params)

    @staticmethod
    def _dense_block_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
        dt = _dtype(cfg)
        return {
            "ln1": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "attn": attn.gqa_init(gen, cfg, dt),
            "ln2": layers.rms_norm_init(cfg.d_model, dt, gen.device),
            "mlp": layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt),
        }

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ---------------------------------------------------------- forward ---

    def _embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(self.embed, tokens)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (the train / prefill compute)."""
        cfg = self.cfg
        x = self._embed_inputs(tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        for bp in self.blocks:
            x = _dense_block(bp, x, positions, cfg)
        x = layers.rms_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return layers.unembed(self.embed, x)
        return layers.lm_head(self.lm_head, x)

    # ------------------------------------------------------------ cache ---

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        return attn.gqa_init_cache(self.cfg, batch_size, cache_len,
                                   self.cfg.num_layers, _dtype(self.cfg),
                                   self.device)

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
        slot, nvalid = attn.gqa_decode_slots(pos, cache["k"].shape[2])
        for i, bp in enumerate(self.blocks):
            x = self._dense_decode_block(bp, x, cache["k"][i],
                                         cache["v"][i], pos, slot, nvalid)
        return x

    def _dense_decode_block(self, bp, x, cache_k, cache_v, pos, slot,
                            nvalid):
        cfg = self.cfg
        h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
        x = x + attn.gqa_decode(bp["attn"], h, cache_k, cache_v, pos, slot,
                                nvalid, cfg)
        h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
        return x + layers.swiglu(bp["mlp"], h)

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
        for i, bp in enumerate(self.blocks):
            h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
            out, kk, vv = attn.gqa_forward(bp["attn"], h, positions, cfg,
                                           return_kv=True)
            self._fill_ring(cache["k"][i], kk)
            self._fill_ring(cache["v"][i], vv)
            x = x + out
            h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
            x = x + layers.swiglu(bp["mlp"], h)
        return x, cache
