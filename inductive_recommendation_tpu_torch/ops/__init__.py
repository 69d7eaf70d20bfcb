"""Sparse products and retrieval ops. ``csr_spmm`` holds the hand-written CUDA
SpMM (``csrc/spmm_csr.cu``) and its plain PyTorch version; ``cosine_topk``
the DOSE selection."""

from inductive_recommendation_tpu_torch.ops.csr_spmm import (
    CsrSpMM,
    build_csr_spmm,
    edge_uniform,
    spmm_csr,
    spmm_csr_cuda,
    spmm_csr_dropout,
    spmm_csr_dropout_reference,
    spmm_csr_reference,
    with_annealed_values,
)
from inductive_recommendation_tpu_torch.ops.cosine_topk import blockwise_cosine_topk
from inductive_recommendation_tpu_torch.ops.spmm import propagate_mean, spmm
from inductive_recommendation_tpu_torch.ops.topk import mask_scores, masked_topk, topk_scores

__all__ = [
    "CsrSpMM",
    "blockwise_cosine_topk",
    "build_csr_spmm",
    "edge_uniform",
    "spmm_csr",
    "spmm_csr_cuda",
    "spmm_csr_dropout",
    "spmm_csr_dropout_reference",
    "spmm_csr_reference",
    "with_annealed_values",
    "propagate_mean",
    "spmm",
    "mask_scores",
    "masked_topk",
    "topk_scores",
]
