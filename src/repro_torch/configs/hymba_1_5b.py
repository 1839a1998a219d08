"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer, meta
tokens, mostly sliding-window attention with a few global layers.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig, register

HYMBA_1_5B = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state_dim=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    num_meta_tokens=128,
    tie_embeddings=True,
    source="[arXiv:2411.13676; hf]",
))
