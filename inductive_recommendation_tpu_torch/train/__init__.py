"""Training: losses, checkpoints and the trainers (BasicTrainer, BPRTrainer,
IGCNTrainer, IDCFTrainer, BCETrainer, MLTrainer, SGLTrainer, HALFTrainer and
the DOSE trainers) on one device."""

from inductive_recommendation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from inductive_recommendation_tpu_torch.train.losses import aux_bpr_w, bce_losses, bpr_loss, info_nce, multinomial_ll_loss
from inductive_recommendation_tpu_torch.train.trainer import (
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
