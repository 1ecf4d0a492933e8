"""zamba2-1.2b: Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, headdim=64, ngroups=1,
                  chunk=256),
    hybrid_attn_every=6,
    source="arXiv:2411.15242 (Zamba2: 38 Mamba2 layers, shared attn block "
           "applied periodically; ssm_state=64)",
)
