"""llava-next-mistral-7b: anyres VLM on the Mistral-7B (SWA 4096) backbone
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower (CLIP ViT-L/336 and its 2-layer MLP projector) is a stub,
as in the reference: the model reads precomputed patch embeddings.  anyres
tiling yields up to 5 tiles x 576 patches = 2880 image tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,   # Mistral-7B-v0.1 backbone SWA
    num_image_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (Mistral-7B backbone, "
           "anyres 2880 img tokens)",
)
