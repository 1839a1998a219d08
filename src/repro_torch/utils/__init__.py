from repro_torch.utils.fingerprint import (  # noqa: F401
    dataset_fingerprint,
    machine_fingerprint,
)
