"""Import side-effect module: loads every per-arch config file so the
registry in ``repro_torch.configs.base`` is populated."""
import repro_torch.configs.yi_34b  # noqa: F401
import repro_torch.configs.qwen2_0_5b  # noqa: F401
import repro_torch.configs.mistral_large_123b  # noqa: F401
import repro_torch.configs.qwen3_1_7b  # noqa: F401
import repro_torch.configs.granite_moe_3b_a800m  # noqa: F401
import repro_torch.configs.mixtral_8x22b  # noqa: F401
import repro_torch.configs.mamba2_780m  # noqa: F401
import repro_torch.configs.phi_3_vision_4_2b  # noqa: F401
import repro_torch.configs.whisper_large_v3  # noqa: F401
import repro_torch.configs.hymba_1_5b  # noqa: F401
