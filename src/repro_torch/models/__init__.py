from repro_torch.models.lm import DecoderLM, build_model  # noqa: F401
