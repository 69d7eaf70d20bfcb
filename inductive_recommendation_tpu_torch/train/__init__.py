"""Training: losses, checkpoints (the port's and the JAX package's msgpack),
meters and the trainers (BasicTrainer, BPRTrainer, IGCNTrainer, IDCFTrainer,
BCETrainer, MLTrainer, SGLTrainer, HALFTrainer and the DOSE trainers; each
also on a mesh, data-parallel or, for a model with a graph propagation, with
the graph sharded under ``parallel.placement``'s edge placement).
``train.import_reference``
converts the reference's ``.pth`` files."""

from inductive_recommendation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from inductive_recommendation_tpu_torch.train.losses import aux_bpr_w, bce_losses, bpr_loss, info_nce, multinomial_ll_loss
from inductive_recommendation_tpu_torch.train.meters import AverageMeter
from inductive_recommendation_tpu_torch.train.trainer import (
    OPTIMIZERS,
    TRAINERS,
    BasicTrainer,
    BCETrainer,
    BPRTrainer,
    ContrastiveBPRTrainer,
    DOSEaugTrainer,
    DOSEdropTrainer,
    DOSEtestTrainer,
    HALFTrainer,
    IDCFTrainer,
    IGCNTrainer,
    MLTrainer,
    SGLTrainer,
    get_trainer,
)

__all__ = [
    "AverageMeter",
    "BasicTrainer",
    "BCETrainer",
    "BPRTrainer",
    "ContrastiveBPRTrainer",
    "DOSEaugTrainer",
    "DOSEdropTrainer",
    "DOSEtestTrainer",
    "HALFTrainer",
    "IDCFTrainer",
    "IGCNTrainer",
    "MLTrainer",
    "OPTIMIZERS",
    "SGLTrainer",
    "TRAINERS",
    "aux_bpr_w",
    "bce_losses",
    "bpr_loss",
    "get_trainer",
    "info_nce",
    "load_checkpoint",
    "multinomial_ll_loss",
    "save_checkpoint",
]
