"""Data layer: datasets as host data, and the padded per-user matrices that
evaluation places on a device."""

from inductive_recommendation_tpu_torch.data.dataset import (
    BasicDataset,
    ProcessedDataset,
    device_padded_from_lists,
    get_dataset,
    pad_user_lists,
    quick_synthetic_dataset,
)

__all__ = [
    "BasicDataset",
    "ProcessedDataset",
    "device_padded_from_lists",
    "get_dataset",
    "pad_user_lists",
    "quick_synthetic_dataset",
]
