"""Import the reference's torch ``.pth`` checkpoints into port checkpoints
(counterpart of ``inductive_recommendation_tpu/train/import_reference.py``
and its CLI, ``tools/import_reference_ckpt.py``).

The reference saves two torch formats:

- ``BasicModel.save`` (reference model.py:49-53): a raw ``state_dict``
  (``embedding.weight``, ``mlp_layers.0.bias``, ...);
- the IGCN family, IGCN/IMF and every DOSE variant (model.py:4208-4220 and
  the variants' copies, e.g. model.py:601-613): a wrapper
  ``{'sate_dict' (sic), 'user_map', 'item_map', 'alpha'}`` whose maps are
  Python dicts ``{node id: core index}``.

``convert_reference_state`` gives the JAX package's parameter trees and aux
(linear weights transposed to the ``x @ w + b`` form, core maps densified to
-1-padded arrays); flattened to dotted names they are the port's parameter
names. ``import_reference_checkpoint`` writes them as a port checkpoint,
which ``BasicTrainer._load_model`` and ``IDCF_LGCN(lgcn_path=...)`` read; an
IGCN-family model rebuilds its graph buffers (and DOSE views) from the
current dataset, as the reference's ``load`` does.

The JAX package's ``pad_like`` and its ``template`` argument pad tables to a
mesh's row alignment (``table_align``); they wait for the multi-GPU slice.

    python -m inductive_recommendation_tpu_torch.train.import_reference SRC DST [--model NAME] [--n-users N] [--n-items N]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from inductive_recommendation_tpu_torch.models.convert import flatten_params
from inductive_recommendation_tpu_torch.train.checkpoint import save_checkpoint

#: reference model classes whose ``save`` writes the IGCN-family wrapper
IGCN_FAMILY = (
    "IGCN", "IMF", "AttIGCN", "DOSE_aug", "DOSE_aug2", "DOSE_aug3", "DOSE_aug4", "DOSE_drop", "DOSE_drop2",
    "DOSE_drop3", "TEST", "TEST2", "DOSE_aug_drop", "DOSE_aug_drop2", "DOSE_aug_drop3", "DOSE_test",
)

#: reference models saving a single ``embedding.weight`` table
TABLE_MODELS = ("LightGCN", "SGL", "HALF", "IMCGAE", "IDCF_LGCN_pretrain")


def _np(x):
    """torch tensor / numpy / scalar -> numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _dense_map(map_like, length=None):
    """A reference core map (dict {node id: core index}, model.py:4150-4156,
    or an array) -> a -1-padded int64 array of ``length``."""
    if isinstance(map_like, dict):
        if not map_like:
            return np.full(int(length or 0), -1, dtype=np.int64)
        keys = np.asarray([int(k) for k in map_like.keys()], dtype=np.int64)
        vals = np.asarray([int(v) for v in map_like.values()], dtype=np.int64)
        n = int(length) if length is not None else int(keys.max()) + 1
        if keys.max() >= n:
            raise ValueError(
                f"core map has node id {keys.max()} but catalog size is {n} (pass the true n_users/n_items)"
            )
        out = np.full(n, -1, dtype=np.int64)
        out[keys] = vals
        return out
    arr = _np(map_like).astype(np.int64)
    if length is not None and len(arr) < int(length):
        arr = np.concatenate([arr, np.full(int(length) - len(arr), -1, dtype=np.int64)])
    return arr


def _linear(sd, prefix):
    """torch ``Linear`` (weight [out, in], bias [out]) -> {"w": [in, out], "b": [out]}."""
    w = _np(sd[prefix + ".weight"]).astype(np.float32)
    bias = prefix + ".bias"
    b = _np(sd[bias]).astype(np.float32) if bias in sd else np.zeros(w.shape[0], dtype=np.float32)
    return {"w": w.T.copy(), "b": b}


def _linear_list(sd, prefix):
    layers, i = [], 0
    while f"{prefix}.{i}.weight" in sd:
        layers.append(_linear(sd, f"{prefix}.{i}"))
        i += 1
    return layers


def infer_model_name(payload):
    """The reference model class of a loaded ``.pth`` payload, best effort."""
    if isinstance(payload, dict) and "sate_dict" in payload:
        return "IGCN"  # every IGCN-family wrapper converts alike
    keys = set(payload.keys())
    if {"user_embedding.weight", "item_embedding.weight"} <= keys:
        return "MF"
    if "mf_user_embedding.weight" in keys:
        return "NeuMF"
    if "encoder_layers.0.weight" in keys:
        return "MultiVAE"
    if "gc_layers.0.weight" in keys:
        return "NGCF"
    if "gat_units.0.wq.weight" in keys:
        return "IDCF_LGCN"
    if {"embedding.weight", "w"} <= keys:
        return "IGCN"
    if "embedding.weight" in keys:
        return "LightGCN"
    raise ValueError(f"cannot infer reference model from keys {sorted(keys)[:8]}")


def convert_reference_state(payload, model_name=None, n_users=None, n_items=None):
    """A loaded ``.pth`` payload (raw state_dict or the IGCN-family wrapper;
    tensors or numpy) -> (params tree, aux dict), the JAX package's trees.
    ``n_users``/``n_items`` size the densified core maps (a dict map
    otherwise ends at its largest key, short of tail nodes outside the
    core)."""
    model_name = model_name or infer_model_name(payload)
    aux, sd = {}, payload
    if isinstance(payload, dict) and "sate_dict" in payload:
        if model_name not in IGCN_FAMILY:
            raise ValueError(f"wrapper checkpoint ('sate_dict') but model {model_name} is not in the IGCN family")
        sd = payload["sate_dict"]
        aux = {
            "user_map": _dense_map(payload["user_map"], n_users),
            "item_map": _dense_map(payload["item_map"], n_items),
            "alpha": float(payload["alpha"]),
        }

    def table(key):
        return _np(sd[key]).astype(np.float32)

    if model_name in IGCN_FAMILY:
        params = {"embedding": table("embedding.weight")}
        # the SGL-lineage variants keep w commented out (model.py:150): their
        # scoring weight is all ones
        params["w"] = _np(sd["w"]).astype(np.float32) if "w" in sd else np.ones(params["embedding"].shape[1], np.float32)
        return params, aux
    if model_name in TABLE_MODELS:
        return {"embedding": table("embedding.weight")}, aux
    if model_name == "MF":
        return {"user_embedding": table("user_embedding.weight"), "item_embedding": table("item_embedding.weight")}, aux
    if model_name == "NGCF":
        return {
            "embedding": table("embedding.weight"),
            "gc_layers": _linear_list(sd, "gc_layers"),
            "bi_layers": _linear_list(sd, "bi_layers"),
        }, aux
    if model_name == "MultiVAE":
        return {"encoder": _linear_list(sd, "encoder_layers"), "decoder": _linear_list(sd, "decoder_layers")}, aux
    if model_name == "IDCF_LGCN":
        # the frozen pretrained table is a buffer (from lgcn_path), not a
        # parameter; the same .pth converted as 'LightGCN' extracts it
        units, i = [], 0
        while f"gat_units.{i}.wq.weight" in sd:
            units.append({part: _linear(sd, f"gat_units.{i}.{part}") for part in ("wq", "wk", "wv")})
            i += 1
        return {"gat_units": units, "w_out": _linear(sd, "w_out")}, aux
    if model_name == "NeuMF":
        return {
            "mf_user_embedding": table("mf_user_embedding.weight"),
            "mf_item_embedding": table("mf_item_embedding.weight"),
            "mlp_user_embedding": table("mlp_user_embedding.weight"),
            "mlp_item_embedding": table("mlp_item_embedding.weight"),
            "mlp_layers": _linear_list(sd, "mlp_layers"),
            # the bias-free [1, D] fusion layer (model.py:4426) -> [D]
            "output_w": _np(sd["output_layer.weight"]).astype(np.float32).ravel(),
        }, aux
    raise ValueError(
        f"unsupported reference model {model_name!r}; supported: "
        f"{('MF', 'NGCF', 'MultiVAE', 'NeuMF', 'IDCF_LGCN') + TABLE_MODELS + IGCN_FAMILY}"
    )


def load_torch_payload(path):
    """``torch.load`` on the CPU, with ``weights_only=True`` where the payload
    allows it. Otherwise (objects that are not tensors, containers or
    numbers) the full unpickler runs: import only files you trust."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def import_reference_checkpoint(src, dst, model_name=None, n_users=None, n_items=None):
    """Convert the reference ``.pth`` at ``src`` into a port checkpoint at
    ``dst``. Returns (params tree, aux)."""
    params, aux = convert_reference_state(
        load_torch_payload(src), model_name=model_name, n_users=n_users, n_items=n_items
    )
    flat = {name: torch.from_numpy(np.ascontiguousarray(leaf)) for name, leaf in flatten_params(params).items()}
    save_checkpoint(dst, flat, aux=aux)
    return params, aux


def import_for_model(src, dst, model):
    """Convert against a constructed port model: its class names the
    reference model and its catalog sizes the core maps. The written file
    loads through ``BasicTrainer._load_model``."""
    return import_reference_checkpoint(
        src, dst, model_name=type(model).__name__, n_users=model.n_users, n_items=model.n_items
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert a reference .pth checkpoint into a port checkpoint")
    p.add_argument("src", help="reference .pth (raw state_dict or the IGCN-family wrapper)")
    p.add_argument("dst", help="output port checkpoint")
    p.add_argument("--model", default=None, help="reference model class (inferred from the keys if omitted)")
    p.add_argument("--n-users", type=int, default=None, help="catalog size for densifying user_map")
    p.add_argument("--n-items", type=int, default=None, help="catalog size for densifying item_map")
    args = p.parse_args(argv)
    params, aux = import_reference_checkpoint(
        args.src, args.dst, model_name=args.model, n_users=args.n_users, n_items=args.n_items
    )
    shapes = {name: tuple(np.shape(leaf)) for name, leaf in flatten_params(params).items()}
    print(f"wrote {args.dst}: params {shapes}, aux keys {sorted(aux)}")


if __name__ == "__main__":
    main()
