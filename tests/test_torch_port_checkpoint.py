"""The PyTorch port's checkpoint readers against the JAX package: the plain
Python msgpack reader against ``flax.serialization.msgpack_restore``, JAX
checkpoints served by the port's trainers, IDCF_LGCN over a JAX LightGCN
file, and the reference ``.pth`` importer against JAX's
``convert_reference_state``.

Arrays read from msgpack must be bit-equal, with the same dtype and shape;
the converted reference trees bit-equal; metrics served from a JAX
checkpoint within 1e-6 (the same weights, sums in another order); IDCF's
scores within 1e-5."""

import os
import subprocess
import sys

import flax.serialization as fs
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu import get_trainer as jax_get_trainer
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from inductive_recommendation_tpu.train.import_reference import convert_reference_state as jax_convert
from inductive_recommendation_tpu.train.import_reference import infer_model_name as jax_infer_model_name
from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset as port_quick_synthetic_dataset
from inductive_recommendation_tpu_torch.models import flatten_params, params_from_jax
from inductive_recommendation_tpu_torch.train import checkpoint as port_checkpoint
from inductive_recommendation_tpu_torch.train import import_reference as port_import
from inductive_recommendation_tpu_torch.train.msgpack import msgpack_restore, unpackb

D = 16


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(80, 60, 1800, seed=4)


@pytest.fixture(scope="module")
def port_ds():
    return port_quick_synthetic_dataset(80, 60, 1800, seed=4)


def assert_same_tree(got, want, path="tree"):
    """Dicts with the same keys, arrays bit-equal with the same dtype and
    shape, scalars equal and of the same kind."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        if want.dtype == ml_dtypes.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))
            return
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
        assert got.flags.writeable, path
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), (path, got, want)


def _model_cfg(name):
    cfg = {"name": name, "embedding_size": D, "n_layers": 2}
    if name in ("IGCN", "DOSE_aug"):
        cfg.update(dropout=0.0, feature_ratio=1.0)
    if name == "DOSE_aug":
        cfg.update(aug_num=40)
    if name == "NGCF":
        cfg = {"name": "NGCF", "embedding_size": D, "layer_sizes": [D, 8], "dropout": 0.0}
    if name == "IDCF_LGCN":
        cfg.update(n_headers=3, n_samples=6)
    return cfg


def _jax_params(name, dataset):
    cfg = _model_cfg(name)
    if name == "IDCF_LGCN":
        cfg["pretrained_embedding"] = np.random.default_rng(1).normal(
            0, 0.1, (dataset.n_users + dataset.n_items, D)).astype(np.float32)
    model = jax_get_model(cfg, dataset)
    return model, model.init_params(jax.random.key(3))


@pytest.mark.parametrize("name", ["IGCN", "NGCF", "IDCF_LGCN", "DOSE_aug"])
def test_reader_matches_flax_on_jax_checkpoints(ds, tmp_path, name):
    model, params = _jax_params(name, ds)
    opt = optax.adam(1e-3)
    path = tmp_path / "m.ckpt"
    jax_save_checkpoint(path, params, opt_state=opt.init(params), aux=model.checkpoint_aux())
    blob = path.read_bytes()
    assert_same_tree(msgpack_restore(blob), fs.msgpack_restore(blob))
    payload = port_checkpoint.load_checkpoint(path)
    assert payload["format"] == port_checkpoint.JAX_FORMAT
    for k, v in flatten_params(jax.tree_util.tree_map(np.asarray, params)).items():
        assert payload["params"][k].numpy().tobytes() == v.tobytes(), k


def test_reader_restores_long_lists_by_name(tmp_path):
    """A list of 12 equal-shaped leaves is written as a map keyed '0'..'11';
    restored by name it keeps its order ('10' does not land after '1')."""
    layers = [{"w": np.full((3, 2), k, np.float32), "b": np.full(2, -k, np.float32)} for k in range(12)]
    tree = {"embedding": np.arange(6, dtype=np.float32).reshape(3, 2), "layers": layers}
    path = tmp_path / "list.ckpt"
    jax_save_checkpoint(path, tree)
    blob = path.read_bytes()
    assert_same_tree(msgpack_restore(blob), fs.msgpack_restore(blob))
    params = port_checkpoint.load_checkpoint(path)["params"]
    for k in range(12):
        assert torch.equal(params[f"layers.{k}.w"], torch.full((3, 2), float(k)))
        assert torch.equal(params[f"layers.{k}.b"], torch.full((2,), float(-k)))


def test_reader_scalars_strings_and_ext_types():
    tree = {
        "ints": {"a": 0, "b": 127, "c": -1, "d": -32, "e": -33, "f": 255, "g": 65536, "h": -(2**40), "i": 2**64 - 1},
        "floats": {"a": 0.5, "b": -1e300, "c": float("inf")},
        "strs": {"short": "abc", "long": "x" * 300, "utf8": "Gowalla ✓"},
        "bool": True, "false": False, "none": None, "bin": b"\x00\x01" * 200,
        "np_scalar": np.float32(2.5), "np_int": np.int64(-7), "complex": 1.5 - 2j,
        "arrays": {"f64": np.linspace(0, 1, 7), "i32": np.arange(-5, 5, dtype=np.int32),
                   "u8": np.arange(256, dtype=np.uint8).reshape(16, 16), "bool": np.array([True, False]),
                   "bf16": np.arange(8, dtype=np.float32).astype(ml_dtypes.bfloat16), "empty": np.zeros((0, 3)),
                   "scalar0d": np.array(3.0, np.float32)},
        "list": [1, "two", [3.0]],
        "big_map": {str(k): k for k in range(40)},
    }
    blob = fs.msgpack_serialize(tree)
    got, want = msgpack_restore(blob), fs.msgpack_restore(blob)
    assert_same_tree(got["ints"], want["ints"])
    assert_same_tree(got["arrays"], want["arrays"])
    for k in ("floats", "strs", "bool", "false", "none", "bin", "big_map", "complex", "list"):
        assert got[k] == want[k], k
    for k in ("np_scalar", "np_int"):
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k
    with pytest.raises(ValueError, match="trailing"):
        unpackb(blob + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        unpackb(blob[:-3])


def test_reader_chunked_leaf(monkeypatch):
    """A leaf over flax's MAX_CHUNK_SIZE (made small here) is written as a
    chunked-array map by flax's own chunking helper and read back whole."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    big = np.arange(5 * 7, dtype=np.float32).reshape(5, 7)
    tree = {"params": {"embedding": big, "w": np.ones(3, np.float32)}}
    blob = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack_restore(blob)
    assert_same_tree(got, fs.msgpack_restore(blob))
    assert got["params"]["embedding"].tobytes() == big.tobytes()


def _train_jax(name, trainer_name, ds, tmp_path, monkeypatch):
    cfg = {"name": trainer_name, "optimizer": "Adam", "lr": 5e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
           "contrastive_reg": 0.05, "n_epochs": 2, "batch_size": 256, "test_batch_size": 64, "topks": [5, 20]}
    monkeypatch.chdir(tmp_path)
    trainer = jax_get_trainer(cfg, ds, jax_get_model(_model_cfg(name), ds))
    trainer.train(verbose=False)
    return cfg, trainer


@pytest.mark.parametrize("name, trainer_name", [("IGCN", "IGCNTrainer"), ("DOSE_aug", "DOSEaugTrainer")])
def test_jax_trained_checkpoint_serves_in_port(ds, port_ds, tmp_path, monkeypatch, name, trainer_name):
    """A JAX-trained checkpoint loads through the port trainer's
    ``_load_model`` (params by name, the aux's maps, alpha and counters) and
    serves the JAX trainer's metrics."""
    cfg, jt = _train_jax(name, trainer_name, ds, tmp_path, monkeypatch)
    assert jt.save_path and jt.model.alpha < 1.0
    pt = get_trainer(cfg, port_ds, get_model(_model_cfg(name), port_ds, device="cpu"))
    pt._load_model(jt.save_path)
    assert pt.model.alpha == jt.model.alpha
    np.testing.assert_array_equal(pt.model.user_map, np.asarray(jt.model.user_map))
    for stage in ("val", "test"):
        _, want = jt.eval(stage)
        _, got = pt.eval(stage)
        for metric in ("Precision", "Recall", "NDCG"):
            for k in (5, 20):
                assert abs(got[metric][k] - want[metric][k]) <= 1e-6, (stage, metric, k)
    with pytest.raises(ValueError, match="optax"):
        pt.load_state(jt.save_path)


def test_idcf_over_jax_lightgcn_file(ds, port_ds, tmp_path):
    """``lgcn_path`` names a JAX LightGCN checkpoint: the frozen table is the
    file's, and the scores equal JAX's IDCF_LGCN's with the same weights and
    samples."""
    lgcn = jax_get_model({"name": "LightGCN", "embedding_size": D, "n_layers": 2}, ds)
    table = lgcn.init_params(jax.random.key(9))
    path = tmp_path / "lgcn.ckpt"
    jax_save_checkpoint(path, table)
    cfg = dict(_model_cfg("IDCF_LGCN"), lgcn_path=str(path))
    jm = jax_get_model(cfg, ds)
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(cfg, port_ds, device="cpu")
    tp = params_from_jax(tm, jp)
    np.testing.assert_array_equal(tm.frozen_embedding.numpy(), np.asarray(table["embedding"]))
    heads, rng = [], jax.random.key(0)
    for _ in range(jm.n_headers):
        rng, r_u, r_i = jax.random.split(rng, 3)
        heads.append(np.stack([np.asarray(jax.random.randint(r_u, (jm.n_samples,), 0, jm.n_old_users)),
                               np.asarray(jax.random.randint(r_i, (jm.n_samples,), 0, jm.n_old_items))]))
    samples = torch.as_tensor(np.stack(heads), dtype=torch.int64)
    users = np.arange(ds.n_users)
    with torch.no_grad():  # JAX's evaluation draws are key(0)'s, handed to the port
        got = tm.score(tm.get_rep(tp, samples=samples), torch.as_tensor(users)).numpy()
    want = np.asarray(jm.score(jm.get_rep(jp), jnp.asarray(users)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- reference .pth import -------------------------------------------------------------


def _t(rng, *shape):
    return torch.tensor(rng.normal(size=shape).astype(np.float32))


def _reference_cases(rng, n_users=30, n_items=25):
    """The payloads of tests/test_import_reference.py, plus an SGL-lineage
    wrapper without ``w``: (name, payload, convert kwargs)."""
    n = n_users + n_items
    cases = [("LightGCN", {"embedding.weight": _t(rng, n, 16)}, {})]
    wrapper = {"sate_dict": {"embedding.weight": _t(rng, 20, 8), "w": _t(rng, 8)},
               "user_map": {0: 0, 3: 1, 7: 2}, "item_map": {1: 0, 4: 1}, "alpha": 0.97}
    cases.append(("IGCN", wrapper, {"n_users": n_users, "n_items": n_items}))
    cases.append(("IGCN", wrapper, {}))
    cases.append(("DOSE_aug", {"sate_dict": {"embedding.weight": _t(rng, 20, 8)}, "user_map": {0: 0},
                               "item_map": {0: 0}, "alpha": 1.0}, {"model_name": "DOSE_aug", "n_users": 4, "n_items": 3}))
    idcf = {"embedding.weight": _t(rng, n, 8)}
    for i in range(2):
        for part in ("wq", "wk", "wv"):
            idcf[f"gat_units.{i}.{part}.weight"] = _t(rng, 8, 8)
            idcf[f"gat_units.{i}.{part}.bias"] = _t(rng, 8)
    idcf["w_out.weight"], idcf["w_out.bias"] = _t(rng, 8, 16), _t(rng, 8)
    cases.append(("IDCF_LGCN", idcf, {}))
    cases.append(("MF", {"user_embedding.weight": _t(rng, n_users, 8), "item_embedding.weight": _t(rng, n_items, 8)}, {}))
    ngcf = {"embedding.weight": _t(rng, n, 8)}
    for kind in ("gc_layers", "bi_layers"):
        for i, (fin, fout) in enumerate([(8, 8), (8, 4)]):
            ngcf[f"{kind}.{i}.weight"], ngcf[f"{kind}.{i}.bias"] = _t(rng, fout, fin), _t(rng, fout)
    cases.append(("NGCF", ngcf, {}))
    cases.append(("NeuMF", {
        "mf_user_embedding.weight": _t(rng, n_users, 8), "mf_item_embedding.weight": _t(rng, n_items, 8),
        "mlp_user_embedding.weight": _t(rng, n_users, 8), "mlp_item_embedding.weight": _t(rng, n_items, 8),
        "mlp_layers.0.weight": _t(rng, 8, 16), "mlp_layers.0.bias": _t(rng, 8), "output_layer.weight": _t(rng, 1, 16),
    }, {}))
    vae, sizes, dsizes = {}, [n_items, 16, 16], [8, 16, n_items]
    for i in range(2):
        vae[f"encoder_layers.{i}.weight"], vae[f"encoder_layers.{i}.bias"] = _t(rng, sizes[i + 1], sizes[i]), _t(rng, sizes[i + 1])
        vae[f"decoder_layers.{i}.weight"], vae[f"decoder_layers.{i}.bias"] = _t(rng, dsizes[i + 1], dsizes[i]), _t(rng, dsizes[i + 1])
    cases.append(("MultiVAE", vae, {}))
    cases.append(("IGCN", {"embedding.weight": _t(rng, 10, 4), "w": _t(rng, 4)}, {}))
    return cases


@pytest.mark.parametrize("case", range(10))
def test_convert_reference_state_matches_jax(case):
    name, payload, kw = _reference_cases(np.random.default_rng(0))[case]
    params, aux = port_import.convert_reference_state(payload, **kw)
    want_params, want_aux = jax_convert(payload, **kw)
    assert port_import.infer_model_name(payload) == jax_infer_model_name(payload)
    assert_same_tree(flatten_params(params), flatten_params(want_params))
    assert sorted(aux) == sorted(want_aux)
    for k in aux:
        np.testing.assert_array_equal(aux[k], want_aux[k])
        assert type(aux[k]) is type(want_aux[k])


def test_convert_errors_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="cannot infer"):
        port_import.convert_reference_state({"mystery.weight": _t(rng, 3, 3)})
    with pytest.raises(ValueError, match="catalog size"):
        port_import.convert_reference_state(
            {"sate_dict": {"embedding.weight": _t(rng, 4, 2)}, "user_map": {9: 0}, "item_map": {}, "alpha": 1.0},
            n_users=5,
        )
    with pytest.raises(ValueError, match="not in the IGCN family"):
        port_import.convert_reference_state({"sate_dict": {}, "user_map": {}, "item_map": {}, "alpha": 1.0},
                                            model_name="MF")


def test_imported_igcn_serves_through_the_trainer(port_ds, tmp_path, monkeypatch):
    """A reference IGCN wrapper, imported with the CLI entry, loads through
    the port trainer's ``_load_model`` and serves the weights it holds."""
    monkeypatch.chdir(tmp_path)
    cfg = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1,
           "batch_size": 256, "test_batch_size": 64, "topks": [20]}
    model = get_model(_model_cfg("IGCN"), port_ds, device="cpu")
    user_map = {int(u): int(c) for u, c in enumerate(model.user_map) if c >= 0}
    item_map = {int(i): int(c) for i, c in enumerate(model.item_map) if c >= 0}
    rng = np.random.default_rng(2)
    emb, w = _t(rng, model.feat_n_cols, D), torch.tensor(rng.uniform(0.5, 1.5, D).astype(np.float32))
    torch.save({"sate_dict": {"embedding.weight": emb, "w": w}, "user_map": user_map, "item_map": item_map,
                "alpha": 0.97}, tmp_path / "igcn.pth")
    out = subprocess.run(
        [sys.executable, "-m", "inductive_recommendation_tpu_torch.train.import_reference", "igcn.pth", "igcn.ckpt",
         "--n-users", str(port_ds.n_users), "--n-items", str(port_ds.n_items)],
        capture_output=True, text=True, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))},
    )
    assert out.returncode == 0, out.stderr
    trainer = get_trainer(cfg, port_ds, model)
    trainer._load_model(tmp_path / "igcn.ckpt")
    assert torch.equal(trainer.params["embedding"], emb) and torch.equal(trainer.params["w"], w)
    assert model.alpha == pytest.approx(0.97)
    _, metrics = trainer.eval("test")
    assert np.isfinite(metrics["NDCG"][20])
    port_import.import_for_model(tmp_path / "igcn.pth", tmp_path / "igcn2.ckpt", model)
    assert torch.equal(port_checkpoint.load_checkpoint(tmp_path / "igcn2.ckpt")["params"]["embedding"], emb)
