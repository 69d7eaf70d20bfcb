"""Host-side graph builders and node rankings (numpy), and the DOSE
contrastive views built on the device (``views``)."""

from inductive_recommendation_tpu_torch.graph.build import (
    aug_union_edges,
    bipartite_edges,
    build_feat_matrix,
    feat_values_for_alpha,
    row_l1_normalize_values,
    sym_normalize_values,
    sym_normalized_adjacency,
)
from inductive_recommendation_tpu_torch.graph.ranking import (
    graph_aug_rank_nodes,
    graph_drop_rank_nodes,
    graph_rank_nodes,
    rank_nodes_from_edges,
    svd_rank_nodes,
)

__all__ = [
    "aug_union_edges",
    "bipartite_edges",
    "build_feat_matrix",
    "feat_values_for_alpha",
    "graph_aug_rank_nodes",
    "graph_drop_rank_nodes",
    "graph_rank_nodes",
    "rank_nodes_from_edges",
    "row_l1_normalize_values",
    "svd_rank_nodes",
    "sym_normalize_values",
    "sym_normalized_adjacency",
]
