"""Host-side graph builders (numpy)."""

from inductive_recommendation_tpu_torch.graph.build import (
    bipartite_edges,
    build_feat_matrix,
    feat_values_for_alpha,
    row_l1_normalize_values,
    sym_normalize_values,
    sym_normalized_adjacency,
)

__all__ = [
    "bipartite_edges",
    "build_feat_matrix",
    "feat_values_for_alpha",
    "row_l1_normalize_values",
    "sym_normalize_values",
    "sym_normalized_adjacency",
]
