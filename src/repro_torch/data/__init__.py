"""Input pipeline and NVMe tranches, held against ``repro/data``."""
from repro_torch.data.pipeline import (  # noqa: F401
    IOTraceGenerator, IOWorkload, IO_WORKLOADS, Prefetcher, StorageModel,
    SyntheticDataset, input_stall, lm_io_workload, make_batch,
    workload_stall)
from repro_torch.data.storage import (  # noqa: F401
    StorageLease, StoragePool, StorageTranche, make_storage_pool)
