"""Sparse products and retrieval ops. ``csr_spmm`` holds the hand-written CUDA
SpMM (``csrc/spmm_csr.cu``) and its plain PyTorch version; ``attention_csr``
the attention kernels (``csrc/attention_csr.cu``: the scores, the row
softmax's statistics and apply passes, forward and backward) with theirs; ``attention_spmm`` AttIGCN's
attention aggregation over both; ``cosine_topk`` the DOSE selection."""

from inductive_recommendation_tpu_torch.ops.csr_spmm import (
    CsrSpMM,
    build_csr_spmm,
    edge_uniform,
    spmm_csr,
    spmm_csr_cuda,
    spmm_csr_dropout,
    spmm_csr_dropout_reference,
    spmm_csr_reference,
    spmm_csr_values,
    values_layout,
    with_annealed_values,
)
from inductive_recommendation_tpu_torch.ops.attention_spmm import attention_spmm, attention_spmm_fused_kv
from inductive_recommendation_tpu_torch.ops.cosine_topk import blockwise_cosine_topk
from inductive_recommendation_tpu_torch.ops.spmm import propagate_mean, segment_softmax, spmm
from inductive_recommendation_tpu_torch.ops.topk import mask_scores, masked_topk, topk_scores

__all__ = [
    "CsrSpMM",
    "attention_spmm",
    "attention_spmm_fused_kv",
    "blockwise_cosine_topk",
    "build_csr_spmm",
    "edge_uniform",
    "spmm_csr",
    "spmm_csr_cuda",
    "spmm_csr_dropout",
    "spmm_csr_dropout_reference",
    "spmm_csr_reference",
    "spmm_csr_values",
    "values_layout",
    "with_annealed_values",
    "propagate_mean",
    "segment_softmax",
    "spmm",
    "mask_scores",
    "masked_topk",
    "topk_scores",
]
