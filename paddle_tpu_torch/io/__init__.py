"""Datasets and loading (port of ``paddle_tpu/io``)."""
from .batching import PaddedBatcher, bucket_for, pad_to_length  # noqa: F401
from .cursor import DataCursor, resume_batches  # noqa: F401
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import (  # noqa: F401
    BatchSampler, ChainDataset, ComposeDataset, ConcatDataset, Dataset,
    DistributedBatchSampler, IterableDataset, RandomSampler, Sampler,
    SequenceSampler, Subset, TensorDataset, WeightedRandomSampler,
    random_split,
)
from .device_prefetch import (  # noqa: F401
    DevicePrefetchIterator, prefetch_to_device,
)
from .slot_dataset import (  # noqa: F401
    BoxPSDataset, InMemoryDataset, QueueDataset,
)
from .worker import WorkerInfo, get_worker_info  # noqa: F401
