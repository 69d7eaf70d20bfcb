"""Training: losses, checkpoints and the trainers (BasicTrainer, BPRTrainer,
IGCNTrainer) on one device."""

from inductive_recommendation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from inductive_recommendation_tpu_torch.train.losses import aux_bpr_w, bpr_loss
from inductive_recommendation_tpu_torch.train.trainer import (
    TRAINERS,
    BasicTrainer,
    BPRTrainer,
    IGCNTrainer,
    get_trainer,
)

__all__ = [
    "BasicTrainer",
    "BPRTrainer",
    "IGCNTrainer",
    "TRAINERS",
    "aux_bpr_w",
    "bpr_loss",
    "get_trainer",
    "load_checkpoint",
    "save_checkpoint",
]
