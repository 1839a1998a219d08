from repro_torch.utils.tree import (  # noqa: F401
    tree_bytes,
    tree_count,
    tree_map_with_path_str,
    flatten_with_names,
)
from repro_torch.utils.fingerprint import (  # noqa: F401
    dataset_fingerprint,
    machine_fingerprint,
)
