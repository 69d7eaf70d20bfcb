"""The check that nothing the benchmark ran loaded JAX or the JAX package:
top-level module names (the part before the first dot) compared whole, so
that the port, whose name begins with the JAX package's, does not match."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "inductive_recommendation_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))
