"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8, d_ff=512/expert.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig, register

GRANITE_MOE_3B = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
))
