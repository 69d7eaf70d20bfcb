"""Model registry keyed by the reference's class names (reference
model.py:20-25): every model of the JAX package, MF, LightGCN, IGCN, IMF,
AttIGCN, NGCF, IMCGAE, ItemKNN, Popularity, MultiVAE, NeuMF, IDCF_LGCN, SGL,
HALF and the thirteen DOSE variants."""

from inductive_recommendation_tpu_torch.models.att_igcn import AttIGCN
from inductive_recommendation_tpu_torch.models.base import BasicModel
from inductive_recommendation_tpu_torch.models.convert import flatten_params, params_from_jax
from inductive_recommendation_tpu_torch.models.dose import (
    TEST,
    TEST2,
    DOSE_aug,
    DOSE_aug2,
    DOSE_aug3,
    DOSE_aug4,
    DOSE_aug_drop,
    DOSE_aug_drop2,
    DOSE_aug_drop3,
    DOSE_drop,
    DOSE_drop2,
    DOSE_drop3,
    DOSE_test,
)
from inductive_recommendation_tpu_torch.models.idcf import IDCF_LGCN
from inductive_recommendation_tpu_torch.models.igcn import IGCN, IMF
from inductive_recommendation_tpu_torch.models.imcgae import IMCGAE
from inductive_recommendation_tpu_torch.models.itemknn import ItemKNN
from inductive_recommendation_tpu_torch.models.lightgcn import LightGCN
from inductive_recommendation_tpu_torch.models.mf import MF
from inductive_recommendation_tpu_torch.models.multivae import MultiVAE
from inductive_recommendation_tpu_torch.models.neumf import NeuMF
from inductive_recommendation_tpu_torch.models.ngcf import NGCF
from inductive_recommendation_tpu_torch.models.popularity import Popularity
from inductive_recommendation_tpu_torch.models.sgl import HALF, SGL
from inductive_recommendation_tpu_torch.utils.device import resolve_device

DOSE_MODELS = (
    DOSE_aug, DOSE_aug2, DOSE_aug3, DOSE_aug4, DOSE_drop, DOSE_drop2, DOSE_drop3, TEST, TEST2,
    DOSE_aug_drop, DOSE_aug_drop2, DOSE_aug_drop3, DOSE_test,
)
MODELS = {
    cls.__name__: cls
    for cls in (
        MF, LightGCN, IGCN, IMF, AttIGCN, NGCF, IMCGAE, ItemKNN, Popularity, MultiVAE, NeuMF, IDCF_LGCN, SGL, HALF,
        *DOSE_MODELS,
    )
}


def get_model(config, dataset, device=None):
    """Factory keyed by config['name']. Runs on the CUDA card unless ``device``
    says otherwise; raises when no device is given and there is no card."""
    return MODELS[config["name"]](config, dataset, resolve_device(device))


__all__ = [
    "AttIGCN", "BasicModel", "DOSE_MODELS", "HALF", "IDCF_LGCN", "IGCN", "IMCGAE", "IMF", "ItemKNN", "LightGCN",
    "MF", "MODELS", "MultiVAE", "NGCF", "NeuMF", "Popularity", "SGL", "flatten_params", "get_model",
    "params_from_jax",
]
