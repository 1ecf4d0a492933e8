"""phi3-mini-3.8b: RoPE SwiGLU GQA with sliding window [arXiv:2404.14219].

phi3-mini-4k ships sliding_window=2047, which is what makes the `long_500k`
decode shape feasible (ring KV cache of 2047 slots).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    sliding_window=2047,
    source="arXiv:2404.14219 (phi-3-mini: 32L d3072 32H ff8192 vocab 32064, "
           "sliding window 2047)",
)
