"""The multi-GPU layer (counterpart of ``inductive_recommendation_tpu/parallel``):
one process per card, ``torch.distributed`` collectives (NCCL on the card,
gloo for CPU tensors), a ('data', 'model') ``DeviceMesh``.

- ``mesh``: joining the process group, the mesh, the table sharding rule;
- ``collectives``: the counted all-reduce (sum and max) / reduce-scatter /
  all-gather, and their differentiable forms;
- ``spmm``: the edge-block-sharded product, every shard through the
  hand-written SpMM kernel, with shards of per-epoch layouts cut on the
  device and the product with per-edge values;
- ``attention``: AttIGCN's attention softmax and aggregation, sharded;
- ``eval``: item-sharded exact retrieval with a k-way merge;
- ``step``: the data-mode step of every trainer and the edge-mode steps of
  every family with a graph propagation (imported on its own: it depends
  on the training package).

The JAX package's ``parallel/comms.py`` audits XLA's compiled collectives;
here every collective is an explicit call, counted in ``collectives``.
"""

from inductive_recommendation_tpu_torch.parallel.collectives import counts, reset_collective_counts
from inductive_recommendation_tpu_torch.parallel.eval import (
    make_sharded_recommender,
    pad_items_to_mesh,
    sharded_recommend_all_users,
)
from inductive_recommendation_tpu_torch.parallel.mesh import init_distributed, make_mesh, param_spec, shard_params
from inductive_recommendation_tpu_torch.parallel.spmm import (
    EdgeShardedSpMM,
    build_edge_sharded_spmm,
    edge_sharded_spmm,
    make_edge_sharded_propagation,
    make_edge_sharded_spmm,
    shard_csr,
    shard_operand,
)

__all__ = [
    "EdgeShardedSpMM",
    "build_edge_sharded_spmm",
    "counts",
    "edge_sharded_spmm",
    "init_distributed",
    "make_edge_sharded_propagation",
    "make_edge_sharded_spmm",
    "make_mesh",
    "make_sharded_recommender",
    "pad_items_to_mesh",
    "param_spec",
    "reset_collective_counts",
    "shard_csr",
    "shard_operand",
    "shard_params",
    "sharded_recommend_all_users",
]
