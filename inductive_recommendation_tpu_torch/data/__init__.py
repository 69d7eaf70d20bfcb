"""Data layer: datasets as host data, the padded per-user matrices that
evaluation places on a device, and the BPR sampler that draws training
batches on the device."""

from inductive_recommendation_tpu_torch.data.dataset import (
    AuxiliaryDataset,
    BasicDataset,
    ProcessedDataset,
    device_padded_from_lists,
    get_dataset,
    pad_user_lists,
    quick_synthetic_dataset,
)
from inductive_recommendation_tpu_torch.data.sampling import (
    SamplerState,
    build_sampler_state,
    sample_bpr_batch,
)

__all__ = [
    "AuxiliaryDataset",
    "BasicDataset",
    "SamplerState",
    "build_sampler_state",
    "sample_bpr_batch",
    "ProcessedDataset",
    "device_padded_from_lists",
    "get_dataset",
    "pad_user_lists",
    "quick_synthetic_dataset",
]
