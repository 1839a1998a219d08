"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stubbed: the
assignment feeds precomputed patch embeddings via input_specs()).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ModelConfig, register

PHI_3_VISION_4_2B = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,   # MHA (kv == heads)
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,       # 24x24 CLIP-L/14 @336px grid (stub frontend)
    patch_embed_dim=1024,  # CLIP-L hidden size before projection
    rope_theta=10000.0,
    source="[hf:microsoft/Phi-3-vision-128k-instruct; hf]",
))
