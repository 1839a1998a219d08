from repro_torch.kernels import ops  # noqa: F401
from repro_torch.kernels import ref  # noqa: F401
