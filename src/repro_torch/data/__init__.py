from repro_torch.data.arena import ArenaBatch, SlabArena, SlabSlot  # noqa: F401
from repro_torch.data.cache import (  # noqa: F401
    CachedStorage,
    CacheTier,
    plan_hot_chunks,
)
from repro_torch.data.faults import (  # noqa: F401
    FaultPolicy,
    FaultStats,
    FaultyStorage,
    QuarantineLog,
    RetryPolicy,
    StorageFaultSpec,
    quarantine_complement,
)
from repro_torch.data.dataset import (  # noqa: F401
    Dataset,
    default_collate,
    image_batch_transform,
    synthetic_image_dataset,
    token_dataset,
)
from repro_torch.data.loader import (  # noqa: F401
    DataLoader,
    LoaderParams,
    LoaderStream,
    TransferStats,
)
from repro_torch.data.sampler import SamplerState, ShardedSampler  # noqa: F401
from repro_torch.data.storage import (  # noqa: F401
    ArrayStorage,
    BrownoutError,
    CorruptSampleError,
    FileStorage,
    LatencyStorage,
    SampleReadError,
    StorageProfile,
    TransientReadError,
    cifar10_profile,
    coalesce_runs,
    coco_profile,
)
