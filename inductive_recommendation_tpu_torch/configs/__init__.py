"""Experiment grids (reference config.py:1-527), 1:1 name/hyperparameter
parity with the JAX package's."""

from inductive_recommendation_tpu_torch.configs.grids import (
    TOPKS,
    get_alibaba_config,
    get_amazon_config,
    get_gowalla_config,
    get_ml_config,
    get_yelp_config,
)

__all__ = [
    "TOPKS",
    "get_alibaba_config",
    "get_amazon_config",
    "get_gowalla_config",
    "get_ml_config",
    "get_yelp_config",
]
