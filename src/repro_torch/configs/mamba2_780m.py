"""mamba2-780m — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, register

MAMBA2_780M = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
))
