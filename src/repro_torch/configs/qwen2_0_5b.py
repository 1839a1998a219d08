"""qwen2-0.5b — dense GQA with QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig, register

QWEN2_0_5B = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    attn_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="[arXiv:2407.10671; hf]",
))
