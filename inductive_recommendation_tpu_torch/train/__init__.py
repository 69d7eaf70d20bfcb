"""Training: losses, checkpoints and the trainers (BasicTrainer, BPRTrainer,
IGCNTrainer and the DOSE trainers) on one device."""

from inductive_recommendation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from inductive_recommendation_tpu_torch.train.losses import aux_bpr_w, bpr_loss, info_nce
from inductive_recommendation_tpu_torch.train.trainer import (
    TRAINERS,
    BasicTrainer,
    BPRTrainer,
    DOSEaugTrainer,
    DOSEdropTrainer,
    DOSEtestTrainer,
    IGCNTrainer,
    get_trainer,
)

__all__ = [
    "BasicTrainer",
    "BPRTrainer",
    "DOSEaugTrainer",
    "DOSEdropTrainer",
    "DOSEtestTrainer",
    "IGCNTrainer",
    "TRAINERS",
    "aux_bpr_w",
    "bpr_loss",
    "get_trainer",
    "info_nce",
    "load_checkpoint",
    "save_checkpoint",
]
