"""mixtral-8x7b: 8-expert top-2 MoE with SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, num_shared_experts=0, top_k=2,
                  capacity_factor=1.25, expert_d_ff=14336),
    source="arXiv:2401.04088 (Mixtral 8x7B: 32L d4096 8e top-2, SWA 4096)",
)
