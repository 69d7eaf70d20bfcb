from inductive_recommendation_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
