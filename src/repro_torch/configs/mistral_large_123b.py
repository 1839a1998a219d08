"""mistral-large-123b — dense GQA decoder.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ModelConfig, register

MISTRAL_LARGE_123B = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    source="[hf:mistralai/Mistral-Large-Instruct-2407; unverified]",
))
