"""Data layer: the raw parsers, the k-core filter and the chronological split,
datasets as host data, the padded per-user matrices that evaluation places on
a device, and the BPR sampler that draws training batches on the device."""

from inductive_recommendation_tpu_torch.data.dataset import (
    AmazonDataset,
    AuxiliaryDataset,
    BasicDataset,
    GowallaDataset,
    ProcessedDataset,
    SyntheticDataset,
    YelpDataset,
    device_padded_from_lists,
    get_dataset,
    output_data,
    pad_user_lists,
    quick_synthetic_dataset,
)
from inductive_recommendation_tpu_torch.data.sampling import (
    SamplerState,
    build_sampler_state,
    sample_bpr_batch,
)

__all__ = [
    "AmazonDataset",
    "AuxiliaryDataset",
    "BasicDataset",
    "GowallaDataset",
    "SyntheticDataset",
    "YelpDataset",
    "output_data",
    "SamplerState",
    "build_sampler_state",
    "sample_bpr_batch",
    "ProcessedDataset",
    "device_padded_from_lists",
    "get_dataset",
    "pad_user_lists",
    "quick_synthetic_dataset",
]
