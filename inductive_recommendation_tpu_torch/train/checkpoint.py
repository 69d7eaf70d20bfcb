"""Checkpoints: parameters, optimizer state and the model's auxiliary payload
in one ``torch.save`` file (counterpart of
``inductive_recommendation_tpu/train/checkpoint.py``, which writes msgpack).

A file is written to ``<path>.tmp`` and moved into place with
``os.replace``, so a reader never sees half a checkpoint. Numpy arrays in
``aux`` are stored as tensors, so that ``torch.load(weights_only=True)``
reads the file back; ``restore_aux`` takes either.

``load_checkpoint`` also reads the JAX package's msgpack files
(``train/msgpack.py``), told apart by their first bytes: ``torch.save``
writes a zip, which starts with ``PK\\x03\\x04``. msgpack stores lists as maps
keyed '0', '1', ..., so a JAX file's parameter tree is flattened to the
port's dotted names (``gc_layers.0.w``), which restore by name, never by
leaf order (JAX checkpoint.py:40-47)."""

from __future__ import annotations

import os

import numpy as np
import torch

from inductive_recommendation_tpu_torch.train.msgpack import msgpack_restore

ZIP_MAGIC = b"PK\x03\x04"
JAX_FORMAT = "jax-msgpack"


def _storable(value):
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(value, dict):
        return {k: _storable(v) for k, v in value.items()}
    return value


def save_checkpoint(path, params, opt_state=None, aux=None):
    """``params``: {name: tensor}; ``opt_state``: an optimizer's
    ``state_dict()``; ``aux``: a dict of numbers, strings, arrays and tensors."""
    path = os.fspath(path)
    payload = {
        "params": {name: p.detach().cpu() for name, p in params.items()},
        "aux": _storable(aux or {}),
    }
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _from_jax(payload):
    """A JAX checkpoint's tree in the port's form: params {dotted name:
    tensor}, aux as stored (numpy arrays and scalars, Python values). The
    optimizer state is not carried over: optax's Adam tree is not
    ``torch.optim.Adam``'s."""
    from inductive_recommendation_tpu_torch.models.convert import flatten_params  # models import this module

    params = {
        name: torch.as_tensor(np.asarray(leaf)) if not isinstance(leaf, torch.Tensor) else leaf
        for name, leaf in flatten_params(payload.get("params", {})).items()
    }
    return {"params": params, "aux": payload.get("aux", {}) or {}, "format": JAX_FORMAT}


def load_checkpoint(path):
    """``{"params", "aux", ...}`` of a port checkpoint (with ``opt_state``
    when saved) or of a JAX msgpack checkpoint (``format`` is ``JAX_FORMAT``),
    every tensor on the CPU."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == ZIP_MAGIC:
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        return _from_jax(msgpack_restore(f.read()))
