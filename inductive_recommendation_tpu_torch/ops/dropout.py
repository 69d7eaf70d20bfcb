"""Dropout draws (counterpart of ``inductive_recommendation_tpu/ops/dropout.py``).

Edge dropout inside a sparse product is the SpMM kernel's Philox route
(``csr_spmm.spmm_csr_dropout``): the kernel draws the mask from the edge id,
so that the forward and the transpose drop the same edges. What is left here
are dense draws, made on the tensor's device from a generator seeded by one
draw of a CPU generator: a training step stays reproducible from the host
generator's state, and no mask crosses from the host to the card.
"""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_seed


def device_generator(generator: torch.Generator | None, device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw of the CPU ``generator``
    (torch's default one when None)."""
    return torch.Generator(device=device).manual_seed(dropout_seed(generator))


def dropout_keep(shape, p: float, generator: torch.Generator, device) -> torch.Tensor:
    """bool ``shape``: True where u >= p, u uniform in [0, 1) from
    ``generator`` (on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) >= p


def sparse_dropout(val: torch.Tensor, generator: torch.Generator | None, p: float, training: bool) -> torch.Tensor:
    """Bernoulli edge dropout of a value vector with the 1/(1-p) rescale
    (reference model.py:4016-4028): the plain version, for values held
    outside a layout. A layout's products drop edges in the kernel."""
    if not training or p <= 0.0:
        return val
    keep = dropout_keep(val.shape, p, device_generator(generator, val.device), val.device)
    return torch.where(keep, val / (1.0 - p), 0.0)


def node_dropout_mask(generator: torch.Generator | None, n_nodes: int, p: float, training: bool, device) -> torch.Tensor:
    """fp32 [n_nodes]: 1/(1-p) where a node is kept, else 0; all ones when not
    training or p <= 0 (IMCGAE, model.py:4331-4334)."""
    if not training or p <= 0.0:
        return torch.ones(n_nodes, dtype=torch.float32, device=device)
    keep = dropout_keep((n_nodes,), p, device_generator(generator, device), device)
    return torch.where(keep, 1.0 / (1.0 - p), 0.0)
