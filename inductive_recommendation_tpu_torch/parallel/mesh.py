"""Process groups, the ('data', 'model') mesh and the parameter sharding rule
(counterpart of ``inductive_recommendation_tpu/parallel/mesh.py``).

One process per card, as ``torchrun`` starts them:

    torchrun --standalone --nproc_per_node 4 -m inductive_recommendation_tpu_torch --mesh 1,4 --mesh-mode edge ...

:func:`init_distributed` joins the group those processes form (NCCL on
``cuda:LOCAL_RANK``; gloo only when the caller asks for the CPU),
:func:`make_mesh` lays the ranks out as a ``DeviceMesh`` with dims
``("data", "model")``: rank = d * n_model + s. Embedding-like tables shard
their rows over 'model' (rank s of a 'model' group keeps rows
``[s * blk, (s + 1) * blk)``); everything else is replicated.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from inductive_recommendation_tpu_torch.parallel.collectives import all_gather

AXES = ("data", "model")

# parameter partition rule: embedding-like tables row-sharded over 'model',
# everything else replicated (JAX mesh.py:32-40)
_TABLE_KEYS = (
    "embedding",
    "user_embedding",
    "item_embedding",
    "mf_user_embedding",
    "mf_item_embedding",
    "mlp_user_embedding",
    "mlp_item_embedding",
)


def init_distributed(device=None, init_method=None) -> torch.device:
    """Join the process group of this run and return this rank's device.

    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` are read as ``torchrun`` sets
    them (0 / 1 / 0 when unset). On the card the rank runs on
    ``cuda:LOCAL_RANK`` over NCCL; ``device="cpu"`` runs it over gloo. It
    raises when the card or NCCL is missing and the CPU was not asked for.
    The group's rendezvous is ``init_method`` when given, else torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``), else, for a group of one,
    a file store in a fresh temporary directory. A group already joined is
    kept (its backend must match)."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for the gloo group on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; the multi-GPU layer needs it on the card")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} CUDA devices")
        backend, dev = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
        return dev
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world == 1:
            init_method = "file://" + os.path.join(tempfile.mkdtemp(prefix="irt_pg_"), "store")
        else:
            raise RuntimeError(f"WORLD_SIZE {world} without MASTER_ADDR: start the ranks with torchrun")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kwargs)
    return dev


def make_mesh(n_data: int | None = None, n_model: int | None = None):
    """``DeviceMesh`` over every rank with dims ('data', 'model'). Defaults
    (JAX mesh.py:10-27): all ranks on 'model'; given one size, the other is
    what is left. The group must be joined (:func:`init_distributed`)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_data is None and n_model is None:
        n_data, n_model = 1, n
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"mesh ({n_data}, {n_model}) does not cover the {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def param_spec(name: str, value) -> str | None:
    """The mesh axis a parameter's rows shard over: 'model' for a table (a
    2-D leaf named in ``_TABLE_KEYS``), None (replicated) for the rest."""
    return "model" if name.split(".")[-1] in _TABLE_KEYS and value.ndim == 2 else None


def local_rows(t: torch.Tensor, mesh, axis: str = "model", n_rows: int | None = None) -> torch.Tensor:
    """This rank's block of ``t``'s rows, ``t`` first zero-padded (or cut) to
    ``n_rows`` rows (default: up to a multiple of the axis size)."""
    S = axis_size(mesh, axis)
    n_rows = -(-t.shape[0] // S) * S if n_rows is None else n_rows
    if n_rows % S:
        raise ValueError(f"{n_rows} rows do not split over {S} shards")
    blk, s = n_rows // S, mesh.get_local_rank(axis)
    out = t.new_zeros((blk, *t.shape[1:]))
    lo, hi = s * blk, min((s + 1) * blk, t.shape[0])
    if hi > lo:
        out[: hi - lo] = t[lo:hi]
    return out


@torch.no_grad()
def gather_rows(t_local: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The whole (padded) table from every rank's row block."""
    return all_gather(t_local.detach(), mesh.get_group(axis))


def shard_params(params: dict, mesh) -> dict:
    """Fresh leaf tensors for this rank: tables (:func:`param_spec`) hold their
    row block over 'model' (rows zero-padded to a multiple of its size; the
    pad rows are never read), the rest a copy."""
    out = {}
    for name, v in params.items():
        v = v.detach()
        t = local_rows(v, mesh) if param_spec(name, v) else v.clone()
        out[name] = t.requires_grad_(v.requires_grad or v.is_floating_point())
    return out
