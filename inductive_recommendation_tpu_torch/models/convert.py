"""Carry a JAX parameter dictionary into a port model.

The JAX package's models keep their parameters as a flat ``{name: array}``
dictionary with the same names as the port's ``nn.Parameter``s: IGCN/IMF
``embedding`` ``[feat_n_cols (aligned), d]`` and ``w`` ``[d]``, LightGCN
``embedding`` ``[n_users + n_items (aligned), d]``. Pass the arrays as numpy
(``np.asarray`` of each JAX array), so that this module needs no JAX."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def params_from_jax(model, params) -> dict[str, torch.Tensor]:
    """Copy ``params`` into ``model``'s parameters in place; returns
    ``model.params()``. Raises on a missing or extra name or on a shape that
    differs."""
    own = model.params()
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, unexpected {extra}")
    # np.array copies: a JAX array's numpy view is read-only
    arrays = {name: np.array(params[name], dtype=np.float32) for name in own}
    for name, p in own.items():
        if arrays[name].shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {arrays[name].shape} != the model's {tuple(p.shape)}")
    for name, p in own.items():
        p.copy_(torch.from_numpy(arrays[name]))
    return own
