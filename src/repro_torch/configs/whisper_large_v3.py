"""whisper-large-v3 — encoder-decoder audio backbone; conv frontend stubbed
(input_specs() feeds precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig, register

WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,           # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,         # MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    attn_bias=True,
    max_source_positions=1500,
    mlp_activation="gelu",
    tie_embeddings=True,
    source="[arXiv:2212.04356; unverified]",
))
