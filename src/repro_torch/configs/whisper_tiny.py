"""whisper-tiny: encoder-decoder audio model [arXiv:2212.04356].

The mel-spectrogram and conv frontend are a stub, as in the reference:
the model reads the 1500 frame embeddings the conv stack would produce
for 30 s of audio.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    encoder_seq_len=1500,    # 30s @ 50Hz after conv stride 2
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    tie_embeddings=True,
    attention="gqa",
    source="arXiv:2212.04356 (Whisper tiny: 4+4L d384 6H ff1536 vocab 51865)",
)
