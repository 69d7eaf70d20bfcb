"""PyTorch + CUDA port of ``inductive_recommendation_tpu`` for an NVIDIA H100.

The JAX package beside this one is the reference: every ported function is
tested against its JAX counterpart on the same inputs. This package imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package. Its module
names mirror the JAX package's.

The sparse product at the bottom of every graph model is a hand-written CUDA
kernel (``ops/csrc/spmm_csr.cu``), built with ``nvcc`` at first use; on CPU
tensors the same functions run their plain PyTorch versions. The entry points
run on the CUDA card unless the caller passes ``device="cpu"``:

    from inductive_recommendation_tpu_torch import get_dataset, get_model, get_trainer

    ds = get_dataset({"name": "ProcessedDataset", "path": "data/Gowalla/time"})
    model = get_model({"name": "IGCN", "embedding_size": 64, "n_layers": 3,
                       "dropout": 0.3, "feature_ratio": 1}, ds)
    trainer = get_trainer({"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
                           "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1000,
                           "batch_size": 2048, "topks": [20]}, ds, model)
    trainer.train()                        # writes checkpoints/ in the working directory
    results, metrics = trainer.eval("test")

Ported so far: the serving path (datasets, graph builders, node rankings,
LightGCN/IGCN/IMF representations, full-catalog and inductive evaluation),
the training path (the BPR sampler, the losses, BasicTrainer/BPRTrainer/
IGCNTrainer with Adam, early stopping and checkpoints), whose backward runs
the same kernel on the transpose layouts, the DOSE family (its 13 variants,
their contrastive views as symmetric CSRs rebuilt on the device at every
epoch end, the cosine top-k selection, InfoNCE and the DOSE trainers), and
every other model and trainer of the JAX package (the grids' baselines,
AttIGCN's attention aggregation through the kernel with learned edge values,
SGL and HALF), the raw Gowalla/Yelp/Amazon preprocessing over the native
k-core (``native/graph_core.cpp``, built with ``g++`` at first use), the
reference's ``.pth`` and the JAX package's msgpack checkpoints, the run
utilities and the command line:

    python -m inductive_recommendation_tpu_torch --preprocess gowalla --data-path RAW --out-path data/Gowalla/time
    python -m inductive_recommendation_tpu_torch --grid gowalla --index 2 --stage test

and the multi-GPU layer (``parallel/``: one process a card over NCCL, a
('data', 'model') mesh, the edge-sharded SpMM, AttIGCN's sharded attention,
item-sharded retrieval, data mode for every trainer, ``EdgeShardedTrainer``
for every model with a graph propagation):

    torchrun --standalone --nproc_per_node 4 -m inductive_recommendation_tpu_torch --grid gowalla --index 2 \
        --mesh 1,4 --mesh-mode edge
"""

__version__ = "0.1.0"

_LAZY = {
    "get_dataset": "inductive_recommendation_tpu_torch.data",
    "get_model": "inductive_recommendation_tpu_torch.models",
    "get_trainer": "inductive_recommendation_tpu_torch.train",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["get_dataset", "get_model", "get_trainer", "__version__"]
