"""mixtral-8x22b — MoE 8 experts top-2 with sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, register

MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    moe_d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="[arXiv:2401.04088; hf]",
))
