"""Model registry keyed by the reference's class names (reference
model.py:20-25). Ported so far: LightGCN, IGCN, IMF and twelve of the
thirteen DOSE variants (not DOSE_aug2)."""

from inductive_recommendation_tpu_torch.models.base import BasicModel
from inductive_recommendation_tpu_torch.models.convert import params_from_jax
from inductive_recommendation_tpu_torch.models.dose import (
    NOT_PORTED,
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
from inductive_recommendation_tpu_torch.models.igcn import IGCN, IMF
from inductive_recommendation_tpu_torch.models.lightgcn import LightGCN
from inductive_recommendation_tpu_torch.utils.device import resolve_device

DOSE_MODELS = (
    DOSE_aug, DOSE_aug3, DOSE_aug4, DOSE_drop, DOSE_drop2, DOSE_drop3, TEST, TEST2,
    DOSE_aug_drop, DOSE_aug_drop2, DOSE_aug_drop3, DOSE_test,
)
MODELS = {cls.__name__: cls for cls in (LightGCN, IGCN, IMF, *DOSE_MODELS)}


def get_model(config, dataset, device=None):
    """Factory keyed by config['name']. Runs on the CUDA card unless ``device``
    says otherwise; raises when no device is given and there is no card."""
    if config["name"] in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[config["name"]])
    return MODELS[config["name"]](config, dataset, resolve_device(device))


__all__ = ["BasicModel", "DOSE_MODELS", "IGCN", "IMF", "LightGCN", "MODELS", "get_model", "params_from_jax"]
