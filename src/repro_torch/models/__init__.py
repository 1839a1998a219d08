from repro_torch.models.lm import (DecoderLM, EncDecLM,  # noqa: F401
                                   build_model, param_specs)
