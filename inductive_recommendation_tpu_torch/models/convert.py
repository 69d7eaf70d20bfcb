"""Carry a JAX parameter pytree into a port model.

The JAX package's models keep their parameters as a pytree of dicts and
lists (NGCF ``{"embedding", "gc_layers": [{"w", "b"}, ...], ...}``, IDCF
``{"gat_units": [{"wq": {"w", "b"}, ...}, ...], "w_out": ...}``). Flattened
to dotted names (``gc_layers.0.w``, ``gat_units.3.wk.b``,
``mlp_layers.1.w``) they are the names of the port's ``nn.Parameter``s, as
``named_parameters`` gives them. Pass the leaves as numpy or as JAX arrays
(``np.array`` reads either), so that this module needs no JAX."""

from __future__ import annotations

import numpy as np
import torch


def flatten_params(tree, prefix: str = "") -> dict:
    """{dotted name: leaf} of a tree of dicts and lists/tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(flatten_params(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


@torch.no_grad()
def params_from_jax(model, params) -> dict[str, torch.Tensor]:
    """Copy ``params`` (flat or nested) into ``model``'s parameters in place;
    returns ``model.params()``. Raises on a missing or extra name or on a
    shape that differs."""
    own = model.params()
    params = flatten_params(params)
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
