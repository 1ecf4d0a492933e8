"""Configuration dataclasses, the reference ``repro.configs.base`` field for
field (names, defaults, ``resolved_head_dim``, ``subquadratic`` and
``reduced()`` are held equal by the tests).

:class:`ModelConfig` and its sub-configs are pure data; the port runs
every family of the reference (``repro_torch.models``), and
:class:`TrainConfig` feeds ``repro_torch.optim.make_optimizer``.
``GFLConfig.async_spec`` is read by the event engine
(``repro_torch.core.events``), ``sanitize`` by :mod:`repro_torch.sanitize`,
``telemetry`` by :mod:`repro_torch.telemetry`, and the mesh knobs
(``combine_impl``, ``combine_wire``, ``grad_acc_dtype``,
``client_parallel``) by the mesh trainer (``repro_torch.launch.steps``).
Input shapes come from the fixed :data:`INPUT_SHAPES` registry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class GFLConfig:
    """Graph-federated-learning protocol knobs (Rizk & Sayed 2021)."""
    num_servers: int = 10            # P
    clients_per_server: int = 50     # K
    clients_sampled: int = 0         # L; 0 -> full participation
    topology: str = "ring"           # ring | torus | full | erdos |
                                     # hypercube | expander
    topology_seed: int = 0           # seed for randomized graph families
    torus_rows: int = 0              # torus row count; 0 -> near-square auto
    fault: str = "none"              # resilience fault spec
    population: str = "dense"        # client-population spec
    cohort: str = "uniform"          # cohort-scheduler spec
    async_spec: str = "none"         # event-driven executor spec
                                     # (repro_torch.core.events)
    data_seed: int = 0               # seed of the lazy population generator
    privacy: str = "hybrid"          # registry key into
                                     # repro_torch.core.privacy.mechanism
    sigma_g: float = 0.2             # server-level noise std
    grad_bound: float = 10.0         # B in Assumption 3 (clipping threshold)
    mu: float = 0.1                  # step size
    epsilon_target: float = 0.0      # scheduled mechanism: total eps budget
    epsilon_horizon: int = 0         # scheduled mechanism: budget horizon
    secure_agg: bool = True          # pairwise-mask SMC at client level
    combine_impl: str = "dense"      # mesh combine: dense | rotate | sparse
    combine_every: int = 1           # combine every tau steps
    use_kernels: bool = False        # whole-run switch: route the round
                                     # through the CUDA kernels
                                     # (repro_torch.kernels.ops)
    combine_wire: str = "bf16"       # mesh combine's accumulation: bf16
                                     # (the leaf dtype) | f32
    grad_acc_dtype: str = "float32"  # mesh step's client-gradient sum
    client_parallel: bool = False    # mesh step: clients over "model"
    sanitize: bool = False           # runtime sanitizer
    telemetry: str = "off"           # telemetry sinks

    @property
    def effective_clients(self) -> int:
        return self.clients_sampled or self.clients_per_server


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    num_shared_experts: int = 0   # always-on experts (DeepSeek style)
    top_k: int = 2
    capacity_factor: float = 1.25
    expert_d_ff: int = 0          # d_ff of each routed expert
    router_aux_coef: float = 0.01
    first_dense_layers: int = 0   # leading layers that stay dense (DeepSeek)
    first_dense_d_ff: int = 0
    dispatch: str = "global"      # global: capacity over all tokens (t5x);
                                  # row: per-batch-row dispatch — scatter
                                  # stays local to the data shard (§Perf)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 -> no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""
    state_dim: int = 64
    conv_dim: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 (Finch) block config."""
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    gate_lora: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    max_seq_len: int = 1 << 20
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0       # 0 -> full attention
    attention: str = "gqa"        # gqa | mla | none
    mlp: str = "swiglu"           # swiglu | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (zamba2): indices (mod pattern) at which the shared attn block fires
    hybrid_attn_every: int = 0    # 0 -> not hybrid; else attn after every N ssm blocks
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq_len: int = 0      # fixed encoder frames (whisper: 1500)
    # vlm
    num_image_tokens: int = 0     # prepended stub patch embeddings
    # citation for provenance
    source: str = ""
    param_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True if the arch supports O(window)/O(1)-state 500k decode."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        head_dim = max(d_model // num_heads, 32)
        kv = max(1, min(self.num_kv_heads, num_heads))
        while num_heads % kv:  # kv must divide heads (GQA grouping)
            kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=min(self.moe.expert_d_ff or 128, 128),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                first_dense_d_ff=min(self.moe.first_dense_d_ff or 256, 256),
            )
        mla = None
        if self.mla is not None:
            mla = dataclasses.replace(
                self.mla,
                kv_lora_rank=min(self.mla.kv_lora_rank, 64),
                q_lora_rank=min(self.mla.q_lora_rank, 64),
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, state_dim=16, headdim=32, chunk=32)
        rwkv = None
        if self.rwkv is not None:
            rwkv = dataclasses.replace(
                self.rwkv, head_size=32, decay_lora=16, mix_lora=8, gate_lora=16)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=kv,
            head_dim=head_dim if self.head_dim else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            moe=moe,
            mla=mla,
            ssm=ssm,
            rwkv=rwkv,
            hybrid_attn_every=min(self.hybrid_attn_every, 1) if self.hybrid_attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq_len=min(self.encoder_seq_len, 64) if self.encoder_seq_len else 0,
            num_image_tokens=min(self.num_image_tokens, 16) if self.num_image_tokens else 0,
            param_dtype="float32",
        )


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"           # sgd | momentum | adam | adamw
    learning_rate: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 1000
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip: float = 0.0           # global-norm clip; 0 -> off
    microbatch: int = 0              # 0 -> no grad accumulation
    remat: bool = True
    seed: int = 0
