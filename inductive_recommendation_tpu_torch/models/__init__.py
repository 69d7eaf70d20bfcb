"""Model registry keyed by the reference's class names (reference
model.py:20-25). Ported: every model of the paper's experiment grids
(``configs/grids.py``): MF, LightGCN, IGCN, IMF, NGCF, IMCGAE, IDCF_LGCN,
ItemKNN, Popularity, MultiVAE, NeuMF and twelve of the thirteen DOSE
variants. ``get_model`` raises ``NotImplementedError`` for the rest
(``NOT_PORTED``)."""

from inductive_recommendation_tpu_torch.models.base import BasicModel
from inductive_recommendation_tpu_torch.models.convert import flatten_params, params_from_jax
from inductive_recommendation_tpu_torch.models.dose import (
    TEST,
    TEST2,
    DOSE_aug,
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
from inductive_recommendation_tpu_torch.utils.device import resolve_device

DOSE_MODELS = (
    DOSE_aug, DOSE_aug3, DOSE_aug4, DOSE_drop, DOSE_drop2, DOSE_drop3, TEST, TEST2,
    DOSE_aug_drop, DOSE_aug_drop2, DOSE_aug_drop3, DOSE_test,
)
MODELS = {
    cls.__name__: cls
    for cls in (
        MF, LightGCN, IGCN, IMF, NGCF, IMCGAE, IDCF_LGCN, ItemKNN, Popularity, MultiVAE, NeuMF, *DOSE_MODELS
    )
}
NOT_PORTED = {
    "DOSE_aug2": "DOSE_aug2 is not ported yet: it rebuilds the feature matrix over the augmented graph every "
    "epoch and needs the rectangular feature-matrix delta (JAX graph/views.py device_make_feat_delta); "
    "ROADMAP.md section 1",
    "SGL": "SGL is not ported yet (with SGLTrainer); ROADMAP.md section 1",
    "HALF": "HALF is not ported yet (with HALFTrainer); ROADMAP.md section 1",
    "AttIGCN": "AttIGCN is not ported yet: it needs the attention SpMM (JAX ops/attention_spmm.py); "
    "ROADMAP.md section 1",
}


def get_model(config, dataset, device=None):
    """Factory keyed by config['name']. Runs on the CUDA card unless ``device``
    says otherwise; raises when no device is given and there is no card."""
    if config["name"] in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[config["name"]])
    return MODELS[config["name"]](config, dataset, resolve_device(device))


__all__ = [
    "BasicModel", "DOSE_MODELS", "IDCF_LGCN", "IGCN", "IMCGAE", "IMF", "ItemKNN", "LightGCN", "MF", "MODELS",
    "MultiVAE", "NGCF", "NOT_PORTED", "NeuMF", "Popularity", "flatten_params", "get_model", "params_from_jax",
]
