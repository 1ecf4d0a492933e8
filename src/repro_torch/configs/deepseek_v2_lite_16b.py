"""deepseek-v2-lite-16b: MLA + fine-grained MoE [arXiv:2405.04434].

MLA kv_lora_rank=512; MoE: 2 shared + 64 routed experts, top-6, expert
d_ff=1408; first layer dense (d_ff 10944).  27 layers, d_model 2048.
"""
from repro_torch.configs.base import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  capacity_factor=1.25, expert_d_ff=1408,
                  first_dense_layers=1, first_dense_d_ff=10944),
    source="arXiv:2405.04434 (DeepSeek-V2-Lite: 27L d2048, MLA kv_lora 512, "
           "2 shared + 64 routed top-6)",
)
