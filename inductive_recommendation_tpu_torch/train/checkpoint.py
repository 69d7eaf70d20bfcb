"""Checkpoints: parameters, optimizer state and the model's auxiliary payload
in one ``torch.save`` file (counterpart of
``inductive_recommendation_tpu/train/checkpoint.py``, which writes msgpack).

A file is written to ``<path>.tmp`` and moved into place with
``os.replace``, so a reader never sees half a checkpoint. Numpy arrays in
``aux`` are stored as tensors, so that ``torch.load(weights_only=True)``
reads the file back; ``restore_aux`` takes either."""

from __future__ import annotations

import os

import numpy as np
import torch


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


def load_checkpoint(path):
    """The payload of :func:`save_checkpoint`, with every tensor on the CPU."""
    return torch.load(os.fspath(path), map_location="cpu", weights_only=True)
