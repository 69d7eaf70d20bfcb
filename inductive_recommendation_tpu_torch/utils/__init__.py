"""Run utilities (reference utils.py:13-30, 280-305), tracing and timing, and
the device helpers."""

from inductive_recommendation_tpu_torch.utils.device import resolve_device
from inductive_recommendation_tpu_torch.utils.profiles import dense_profiles
from inductive_recommendation_tpu_torch.utils.profiling import StepTimer, nan_check, trace
from inductive_recommendation_tpu_torch.utils.run import Unbuffered, init_run, set_seed

__all__ = [
    "StepTimer", "Unbuffered", "dense_profiles", "init_run", "nan_check", "resolve_device", "set_seed", "trace",
]
