"""Every model family of the reference as an ``nn.Module``: dense and MoE
with GQA or MLA attention, the ssm family (RWKV-6), the hybrid one (a
Mamba2 stack and one shared attention block), the vlm family (a dense
backbone reading image embeddings ahead of the text) and the audio one
(the whisper encoder-decoder) (mirrors ``repro/models/model.py``).

    model  = Model.init(cfg, generator)          # or Model(cfg, params)
    logits = model.forward(tokens)               # [B, S, V]; model.last_aux
    loss, aux = model.loss(tokens, labels)       # aux: {"ce", "router_aux"}
    logits, cache = model.prefill(tokens)        # fills the cache
    logits, cache = model.decode_step(tokens, cache)

The vlm and audio families take the reference's batch inputs as keywords:
``image_embeds=`` [B, N_img, D] and ``frames=`` [B, Se, D] (the stubbed
vision tower's and conv frontend's outputs), so ``model.loss(**batch)``
reads a reference batch dict.  ``forward`` and ``loss`` are
differentiable for every family; ``prefill`` and ``decode_step`` run
under ``no_grad`` and write in place.

Parameters keep the reference's names and ``[in, out]`` layout; the
reference's stacked ``[n_layers, ...]`` block arrays are one entry of
``blocks`` per layer here (``enc_blocks`` for the whisper encoder), its
``dense_blocks`` (DeepSeek's leading dense layers) first, so a reference
init carries across as a copy (``repro_torch.convert.
model_params_from_numpy``), ``repro_torch.models.flat`` lays them out as
the reference's ``ravel_pytree`` does, and cache layer i belongs to block
i.  A block's FFN is SwiGLU (``mlp``) or the MoE layer (``moe``).  An ssm
block is ``{ln1, att, ln2, ffn}`` (RWKV-6 time and channel mixing), a
hybrid block ``{ln, ssm}`` (Mamba2); the hybrid family's ``shared_attn``
(``{ln, attn, ln2, mlp}``, one set of weights) runs after every
``hybrid_attn_every`` Mamba2 layers (:func:`_hybrid_groups`), each
application with its own KV cache slot, its decode attention through K8.
A whisper decoder block is ``{ln1, attn, ln_x, xattn, ln2, mlp}`` with
LayerNorms and a GELU MLP, no rope, its self-attention decode through K8
and its cross-attention against K/V cached once a prefill; its final norm
is the RMS norm ``final_norm``, as the reference's.  The whisper encoder
runs in the wider of the frames' dtype and the model's, as the
reference's type promotion runs it: a bf16 model's encoder, and its cross
K/V, in f32 on the f32 frames the serve entry draws.  The cache keeps the
cross K/V in f32, as the reference's prefill does.
Logits cover the vocab padded to a multiple of 128, as the reference's
do.  ``forward`` and ``loss`` take the reference's ``remat`` (default on)
and ``remat_policy``: while autograd records, each block the reference
wraps in ``jax.checkpoint`` runs under ``torch.utils.checkpoint`` and is
recomputed in the backward (:func:`_remat`); it moves memory, not values.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rwkv, ssm

# the reference's Model.REMAT_POLICIES, by name and by the jax policy each
# names: None and "full" recompute every activation of a block, "dots"
# keeps the products without batch dimensions, "nothing" keeps nothing
REMAT_POLICIES = {None: None, "full": None, "dots": "dots",
                  "nothing": None,
                  "dots_with_no_batch_dims_saveable": "dots",
                  "nothing_saveable": None}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _promoted(tree, dtype: torch.dtype) -> dict:
    """A block's parameters (nested dicts) in ``dtype``: the reference's
    promotion of a bf16 weight that meets an f32 activation."""
    return {k: v.to(dtype) if isinstance(v, torch.Tensor)
            else _promoted(v, dtype) for k, v in tree.items()}


def padded_vocab(cfg: ModelConfig) -> int:
    """Megatron-style padding of the vocab to a multiple of 128."""
    return -(-cfg.vocab_size // 128) * 128


def check_supported(cfg: ModelConfig) -> None:
    plain = cfg.moe is None and cfg.mla is None
    if cfg.family == "ssm":
        ok = plain and cfg.attention == "none" and cfg.rwkv is not None
    elif cfg.family == "hybrid":
        ok = (plain and cfg.attention == "gqa" and cfg.ssm is not None
              and cfg.hybrid_attn_every > 0)
    elif cfg.family == "audio":
        ok = (plain and cfg.attention == "gqa" and cfg.encoder_layers > 0
              and cfg.encoder_seq_len > 0)
    elif cfg.family == "vlm":
        ok = plain and cfg.attention == "gqa"
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
            f"hybrid_attn_every={cfg.hybrid_attn_every} "
            f"encoder_layers={cfg.encoder_layers}: the port runs the dense "
            "and moe families with gqa or mla attention, ssm with rwkv and "
            "attention none, hybrid with ssm, gqa attention and "
            "hybrid_attn_every > 0, vlm with gqa attention, and audio with "
            "gqa attention and an encoder")


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


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: keep the outputs of the
    2-D products (a weight times the flattened activations), recompute the
    rest, batched attention products included."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: bool, policy):
    """``fn`` (one block) under activation checkpointing when ``remat`` is
    set and autograd is recording, as the reference wraps a block's scan
    body in ``jax.checkpoint``; ``fn`` itself otherwise."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of "
                         f"{sorted(map(str, REMAT_POLICIES))}")
    if not remat or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt
    kw = {}
    if REMAT_POLICIES[policy] == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


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
    phi3, minicpm3; mixtral, deepseek-v2-lite; llava-next-mistral behind
    its image embeddings), an RWKV-6 stack (rwkv6), a Mamba2 stack with a
    shared attention block (zamba2) or the whisper encoder-decoder."""

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
        if cfg.family == "audio":
            self.enc_blocks = nn.ModuleList(
                nn.ModuleDict({part: _params(tree)
                               for part, tree in bp.items()})
                for bp in params["enc_blocks"])
            self.enc_norm = _params(params["enc_norm"])
            self.dec_pos = nn.Parameter(params["dec_pos"],
                                        requires_grad=False)
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
        elif cfg.family == "audio":
            params["enc_blocks"] = [cls._whisper_block_init(cfg, generator)
                                    for _ in range(cfg.encoder_layers)]
            params["enc_norm"] = layers.layer_norm_init(cfg.d_model, dt, dev)
            params["blocks"] = [
                cls._whisper_block_init(cfg, generator, cross=True)
                for _ in range(cfg.num_layers)]
            params["dec_pos"] = (0.02 * layers._normal(
                generator, (dec_pos_rows(cfg), cfg.d_model))).to(dt)
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

    @staticmethod
    def _whisper_block_init(cfg: ModelConfig, gen: torch.Generator,
                            cross: bool = False) -> dict:
        """An encoder block, or with ``cross`` a decoder block (its
        cross-attention ``xattn`` and the norm before it)."""
        dt, dev = _dtype(cfg), gen.device
        bp = {"ln1": layers.layer_norm_init(cfg.d_model, dt, dev),
              "attn": attn.gqa_init(gen, cfg, dt)}
        if cross:
            bp["ln_x"] = layers.layer_norm_init(cfg.d_model, dt, dev)
            bp["xattn"] = attn.gqa_init(gen, cfg, dt)
        bp["ln2"] = layers.layer_norm_init(cfg.d_model, dt, dev)
        bp["mlp"] = layers.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
        return bp

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ---------------------------------------------------------- forward ---

    def _embed_inputs(self, tokens: torch.Tensor,
                      image_embeds: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """[B, S, D]: the image embeddings (cast to the model's dtype)
        ahead of the text for the vlm family; the learned positions added
        for the audio one, taken mod their rows."""
        x = layers.embed(self.embed, tokens)
        if self.cfg.family == "vlm":
            x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
        if self.cfg.family == "audio":
            rows = self.dec_pos.shape[0]
            pos = torch.arange(x.shape[1], device=x.device) % rows
            x = x + self.dec_pos[pos]
        return x

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over the stub frame embeddings [B, Se, D]:
        the sinusoidal table, then non-causal self-attention without
        rope."""
        cfg = self.cfg
        x = frames + sinusoidal(frames.shape[1], cfg.d_model,
                                frames.device).to(frames.dtype)
        # each weight meets x in the wider dtype, as jnp promotes them
        dt = torch.promote_types(x.dtype, _dtype(cfg))
        x = x.to(dt)
        for bp in self.enc_blocks:
            bp = _promoted(bp, dt)
            h = layers.layer_norm(bp["ln1"], x, cfg.norm_eps)
            x = x + attn.gqa_forward(bp["attn"], h, None, cfg,
                                     use_rope=False, causal=False)
            h = layers.layer_norm(bp["ln2"], x, cfg.norm_eps)
            x = x + layers.gelu_mlp(bp["mlp"], h)
        return layers.layer_norm(self.enc_norm, x, cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *,
                image_embeds: torch.Tensor | None = None,
                frames: torch.Tensor | None = None, remat: bool = True,
                remat_policy: str | None = None) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (the train / prefill compute; a
        vlm's S counts its image tokens); the router aux summed over the
        MoE layers is kept as ``last_aux`` (a zero without MoE layers).
        ``remat`` checkpoints each decoder block (the Mamba2 blocks of the
        hybrid family, not its shared block; not the whisper encoder), as
        the reference does."""
        cfg = self.cfg
        x = self._embed_inputs(tokens, image_embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def block(fn):
            return _remat(fn, remat, remat_policy)

        if cfg.family == "audio":
            enc_out = self._encode(frames)
            body = block(lambda x, bp: self._whisper_block(
                bp, x, positions, enc_out)[0])
            for bp in self.blocks:
                x = body(x, bp)
        elif cfg.family == "ssm":
            body = block(lambda x, bp: _rwkv_block(bp, x, cfg)[0])
            for bp in self.blocks:
                x = body(x, bp)
        elif cfg.family == "hybrid":
            body = block(lambda x, bp: _mamba_block(bp, x, cfg)[0])
            for g0, g1, has_attn in _hybrid_groups(cfg):
                for bp in self.blocks[g0:g1]:
                    x = body(x, bp)
                if has_attn:
                    x = self._shared_block(x, positions)[0]
        else:
            def dense(x, bp):
                h = layers.rms_norm(bp["ln1"], x, cfg.norm_eps)
                x = x + _attn(bp, h, positions, cfg)
                h = layers.rms_norm(bp["ln2"], x, cfg.norm_eps)
                out, a = _ffn(bp, h, cfg)
                return x + out, a

            body = block(dense)
            for bp in self.blocks:
                x, a = body(x, bp)
                if a is not None:
                    aux = aux + a
        self.last_aux = aux
        x = layers.rms_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, *,
             mask: torch.Tensor | None = None,
             image_embeds: torch.Tensor | None = None,
             frames: torch.Tensor | None = None, remat: bool = True,
             remat_policy: str | None = None):
        """Next-token cross-entropy plus the router aux; returns (loss,
        {"ce", "router_aux"}).  A vlm's logits are taken past its image
        tokens, as its labels cover the text alone."""
        logits = self.forward(tokens, image_embeds=image_embeds,
                              frames=frames, remat=remat,
                              remat_policy=remat_policy)
        if self.cfg.family == "vlm":
            logits = logits[:, image_embeds.shape[1]:, :]
        ce = layers.cross_entropy(logits, labels, mask)
        aux = self.last_aux
        return ce + aux, {"ce": ce, "router_aux": aux}

    def _whisper_block(self, bp, x, positions, enc_out):
        """A whisper decoder block over a whole sequence; also returns its
        self-attention's K and V and its cross K and V, [B,S,KV,Dh] and
        [B,Se,KV,Dh]."""
        cfg = self.cfg
        h = layers.layer_norm(bp["ln1"], x, cfg.norm_eps)
        out, k, v = attn.gqa_forward(bp["attn"], h, positions, cfg,
                                     use_rope=False, causal=True,
                                     return_kv=True)
        x = x + out
        h = layers.layer_norm(bp["ln_x"], x, cfg.norm_eps)
        xk, xv = attn.cross_kv(bp["xattn"], enc_out, cfg)
        x = x + attn.cross_attend(bp["xattn"], h, xk, xv, cfg)
        h = layers.layer_norm(bp["ln2"], x, cfg.norm_eps)
        return x + layers.gelu_mlp(bp["mlp"], h), (k, v, xk, xv)

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
        c = init(cfg, batch_size, cache_len, L, dt, dev)
        if cfg.family == "audio":
            shape = (L, batch_size, cfg.encoder_seq_len, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            # f32: the promoted encoder's K/V, as the reference's prefill
            # stores them
            c["xk"] = torch.zeros(shape, dtype=torch.float32, device=dev)
            c["xv"] = torch.zeros(shape, dtype=torch.float32, device=dev)
        return c

    # ----------------------------------------------------------- decode ---

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict):
        """One token for every sequence.  tokens: [B] int.  Returns
        (logits [B, V], cache) with the cache advanced in place."""
        cfg = self.cfg
        x = layers.embed(self.embed, tokens[:, None])          # [B,1,D]
        pos = cache["pos"]
        if cfg.family == "audio":
            rows = self.dec_pos.shape[0]
            x = x + self.dec_pos.index_select(
                0, torch.remainder(pos, rows).reshape(1).to(torch.int64))
            x = self._decode_whisper(x, cache)
        elif cfg.family == "ssm":
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

    def _decode_whisper(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """Decoder steps: self-attention (no rope) through K8 over the
        ring, cross-attention against the prefill's K/V."""
        cfg = self.cfg
        pos = cache["pos"]
        slot, nvalid = attn.gqa_decode_slots(pos, cache["k"].shape[2])
        for i, bp in enumerate(self.blocks):
            h = layers.layer_norm(bp["ln1"], x, cfg.norm_eps)
            x = x + attn.gqa_decode(bp["attn"], h, cache["k"][i],
                                    cache["v"][i], pos, slot, nvalid, cfg,
                                    use_rope=False)
            h = layers.layer_norm(bp["ln_x"], x, cfg.norm_eps)
            x = x + attn.cross_attend(bp["xattn"], h, cache["xk"][i],
                                      cache["xv"][i], cfg)
            h = layers.layer_norm(bp["ln2"], x, cfg.norm_eps)
            x = x + layers.gelu_mlp(bp["mlp"], h)
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
    def prefill(self, tokens: torch.Tensor, max_len: int = 0, *,
                image_embeds: torch.Tensor | None = None,
                frames: torch.Tensor | None = None):
        """Run the prompt [B, S] (a vlm's image embeddings ahead of it),
        build the decode cache, return the last position's logits [B, V]
        and the cache.

        max_len: cache capacity (>= prompt + expected decode tokens),
        defaults to prompt + 64; a sliding-window arch caps it at the
        window (a ring)."""
        cfg = self.cfg
        x = self._embed_inputs(tokens, image_embeds)
        B, S, _ = x.shape
        cache = self.init_cache(B, max_len or S + 64)
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.family == "audio":
            x = self._prefill_whisper(x, positions, cache, frames)
        elif cfg.family == "ssm":
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

    def _prefill_whisper(self, x, positions, cache, frames):
        enc_out = self._encode(frames)
        for i, bp in enumerate(self.blocks):
            x, (k, v, xk, xv) = self._whisper_block(bp, x, positions,
                                                    enc_out)
            self._fill_ring(cache["k"][i], k)
            self._fill_ring(cache["v"][i], v)
            cache["xk"][i].copy_(xk)
            cache["xv"][i].copy_(xv)
        return x

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


def dec_pos_rows(cfg: ModelConfig) -> int:
    """Rows of whisper's learned decoder positions: ``max_seq_len``, or
    2^16 where that is 2^17 or more (the reference's cap)."""
    return cfg.max_seq_len if cfg.max_seq_len < 1 << 17 else 1 << 16


def sinusoidal(length: int, dim: int, device=None) -> torch.Tensor:
    """The encoder's sinusoidal positions [length, dim] f32: sines then
    cosines, computed in f64 on the host as the reference's numpy does."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    return torch.tensor(
        np.concatenate([np.sin(angle), np.cos(angle)], axis=-1),
        dtype=torch.float32, device=device)
