"""Model registry keyed by the reference's class names (reference
model.py:20-25). Ported so far: LightGCN, IGCN and IMF."""

from inductive_recommendation_tpu_torch.models.base import BasicModel
from inductive_recommendation_tpu_torch.models.convert import params_from_jax
from inductive_recommendation_tpu_torch.models.igcn import IGCN, IMF
from inductive_recommendation_tpu_torch.models.lightgcn import LightGCN
from inductive_recommendation_tpu_torch.utils.device import resolve_device

MODELS = {cls.__name__: cls for cls in (LightGCN, IGCN, IMF)}


def get_model(config, dataset, device=None):
    """Factory keyed by config['name']. Runs on the CUDA card unless ``device``
    says otherwise; raises when no device is given and there is no card."""
    return MODELS[config["name"]](config, dataset, resolve_device(device))


__all__ = ["BasicModel", "IGCN", "IMF", "LightGCN", "MODELS", "get_model", "params_from_jax"]
