"""Architecture and shape configuration system.

Every assigned architecture is a ``ModelConfig`` registered under its id and
selectable via ``--arch <id>`` in the launchers.  ``ShapeConfig`` carries the
assigned (seq_len, global_batch, kind) cells.  ``reduced()`` derives the tiny
smoke-test variant of any config (same family / code paths, laptop-size).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert FFN width (0 -> use d_ff)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- SSM (mamba2 SSD) ---
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_num_groups: int = 1
    # --- attention details ---
    qk_norm: bool = False
    attn_bias: bool = False          # qwen2-style QKV bias
    sliding_window: int = 0          # 0 = full attention
    global_attn_layers: Tuple[int, ...] = ()  # hymba: layers that stay full-attn
    rope_theta: float = 10000.0
    # --- hybrid (hymba) ---
    num_meta_tokens: int = 0
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    max_source_positions: int = 0    # stub frame-embedding count
    mlp_activation: str = "swiglu"   # swiglu | gelu
    # --- vlm stub ---
    num_patches: int = 0
    patch_embed_dim: int = 0         # incoming (pre-projection) patch dim
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    source: str = ""                 # provenance note [source; tier]

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state_dim else 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Whether the arch supports long-context decode (per-step state
        independent of, or sub-linear in, context length)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch decodes (whisper is enc-dec)

    def param_count(self) -> int:
        """Analytic parameter count N (total, incl. all experts)."""
        d, h, kv, hd, f, v, L = (self.d_model, self.num_heads, self.num_kv_heads,
                                 self.head_dim, self.d_ff, self.vocab_size,
                                 self.num_layers)
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            din, ns = self.d_inner, self.ssm_state_dim
            ng, nh = self.ssm_num_groups, self.ssm_num_heads
            in_proj = d * (2 * din + 2 * ng * ns + nh)
            per_layer = in_proj + (din + 2 * ng * ns) * self.ssm_conv_width \
                + 2 * nh + din + din * d + d  # A,D, gate-norm, out_proj, norm
        else:
            attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            if self.family == "moe":
                mlp = self.num_experts * 3 * d * self.expert_d_ff + d * self.num_experts
            elif self.mlp_activation == "gelu":
                mlp = 2 * d * f
            else:
                mlp = 3 * d * f
            per_layer = attn + mlp + 2 * d
            if self.family == "hybrid" and self.ssm_state_dim:
                din, ns, nh = self.d_inner, self.ssm_state_dim, self.ssm_num_heads
                per_layer += d * (2 * din + 2 * ns + nh) \
                    + (din + 2 * ns) * self.ssm_conv_width + 2 * nh + din * d
        total = emb + L * per_layer
        if self.encoder_layers:
            enc_attn = 2 * (d * h * hd + d * kv * hd)
            enc = self.encoder_layers * (enc_attn + 2 * d * f + 2 * d)
            dec_cross = self.num_layers * (2 * (d * h * hd + d * kv * hd) + d)
            total += enc + dec_cross
        return int(total)

    def active_param_count(self) -> int:
        """N_active: params touched per token (MoE routes top-k of E)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        all_experts = L * self.num_experts * 3 * d * self.expert_d_ff
        active = L * self.experts_per_token * 3 * d * self.expert_d_ff
        return int(self.param_count() - all_experts + active)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# --- assigned shape set (LM transformer family) ---------------------------
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # Import the per-arch modules exactly once (they self-register).
    import repro_torch.configs.archs  # noqa: F401


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """The assigned shape cells that are well-defined for this arch.

    ``long_500k`` requires sub-quadratic attention (SSM / hybrid / sliding
    window); pure full-attention archs skip it (recorded in DESIGN.md).
    """
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.is_subquadratic:
            continue
        out.append(s)
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.family == "moe":
        # capacity_factor = E makes the reduced config fully dropless so
        # prefill/decode paths are bit-comparable in tests.
        kw.update(num_experts=4, experts_per_token=2, moe_d_ff=32,
                  capacity_factor=4.0)
    if cfg.ssm_state_dim:
        kw.update(ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, max_source_positions=16)
    if cfg.num_patches:
        kw.update(num_patches=4, patch_embed_dim=32)
    if cfg.num_meta_tokens:
        kw.update(num_meta_tokens=8)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    if cfg.global_attn_layers:
        kw.update(global_attn_layers=(0,))
    return replace(cfg, **kw)


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=4, kind="train")
SMOKE_DECODE_SHAPE = ShapeConfig("smoke_decode", seq_len=32, global_batch=4, kind="decode")
