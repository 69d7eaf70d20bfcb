"""The port's trainers on a mesh: ``IGCNTrainer`` / ``BPRTrainer`` in edge
mode (IGCN and LightGCN) and in data mode, 2 epochs in 2 gloo ranks,
against the port's single-device trainers of the same seed (the same init,
batches and dropout masks: epoch losses within 1e-5, metrics within 1e-6);
a best checkpoint saved under the mesh and loaded by a single-device
trainer; ``save_state`` / ``load_state`` re-sharding the Adam moments;
``attach_dataset`` + ``inductive_eval``; the families edge mode refuses;
and the command line under ``torch.distributed.run`` against its
single-process line (within 1e-5).

One module-scoped launch of 2 ranks (``parallel.launch.run_ranks``) runs
every trainer; the single-device references run in the test process. The
trainers write ``checkpoints/`` in the working directory: a temporary one.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IGCN = {"name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0}
LGCN = {"name": "LightGCN", "embedding_size": 16, "n_layers": 2}
TRAINER = {"optimizer": "Adam", "lr": 5e-3, "l2_reg": 1e-4, "aux_reg": 0.01, "n_epochs": 2, "batch_size": 128,
           "test_batch_size": 64, "topks": [5, 20], "seed": 3}
# (key, model config, trainer name, mesh shape, mesh mode)
CASES = (
    ("edge_igcn", IGCN, "IGCNTrainer", (1, 2), "edge"),
    ("edge_lgcn", LGCN, "BPRTrainer", (1, 2), "edge"),
    ("data_igcn", IGCN, "IGCNTrainer", (1, 2), "data"),
    ("data_lgcn", LGCN, "BPRTrainer", (2, 1), "data"),
)


def _dataset():
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset

    return quick_synthetic_dataset(150, 120, 2500, seed=1)


def _grown(ds, n_new_users=12, n_new_items=10, seed=8):
    """``ds`` plus new users (8 train + 2 test items each) and new items (6
    old users each, train or test)."""
    from inductive_recommendation_tpu_torch.data import BasicDataset

    rng = np.random.default_rng(seed)
    n_users, n_items = ds.n_users + n_new_users, ds.n_items + n_new_items
    g = BasicDataset({"name": "Grown", "split_ratio": [0.8, 0.1, 0.1]})
    g.n_users, g.n_items = n_users, n_items
    g.train_data = [list(t) for t in ds.train_data]
    g.val_data = [list(v) for v in ds.val_data] + [[] for _ in range(n_new_users)]
    g.test_data = [list(t) for t in ds.test_data]
    for _ in range(n_new_users):
        items = rng.choice(n_items, size=10, replace=False).tolist()
        g.train_data.append(items[:8])
        g.test_data.append(items[8:])
    for item in range(ds.n_items, n_items):
        for u in rng.choice(ds.n_users, size=6, replace=False).tolist():
            (g.train_data if rng.random() < 0.7 else g.test_data)[u].append(item)
    g.train_array = np.array([(u, i) for u, t in enumerate(g.train_data) for i in t], dtype=np.int64)
    return g


def _run(trainer):
    """Train, recording each epoch's loss; -> (losses, best val NDCG)."""
    losses, one_epoch = [], trainer.train_one_epoch

    def recorded():
        losses.append(one_epoch())
        return losses[-1]

    trainer.train_one_epoch = recorded
    best = trainer.train(verbose=False)
    trainer.train_one_epoch = one_epoch
    return losses, best


# -- the rank side (no JAX) -------------------------------------------------------


def trainer_ranks(workdir):
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch import get_model, get_trainer
    from inductive_recommendation_tpu_torch.parallel import make_mesh

    out = {}
    for key, mcfg, tname, shape, mode in CASES:
        os.makedirs(os.path.join(workdir, key), exist_ok=True)
        os.chdir(os.path.join(workdir, key))  # each run its own checkpoints/: names repeat across cases
        ds = _dataset()
        mesh = make_mesh(*shape)
        trainer = get_trainer(dict(TRAINER, name=tname), ds, get_model(mcfg, ds, device="cpu"), mesh=mesh, mesh_mode=mode)
        losses, best = _run(trainer)
        res = {
            "losses": losses, "best": best, "test": trainer.eval("test")[1], "rec": trainer.recommend("test"),
            "save_path": os.path.abspath(trainer.save_path), "params": {k: v.detach().numpy() for k, v in trainer._model_params().items()},
            "alpha": getattr(trainer.model, "alpha", None),
        }
        if key == "edge_igcn":
            state = os.path.join(workdir, "edge_state.ckpt")
            trainer.save_state(state)
            fresh = get_trainer(dict(TRAINER, name=tname), ds, get_model(mcfg, ds, device="cpu"), mesh=mesh, mesh_mode=mode)
            fresh.load_state(state)
            res["state_path"] = state
            res["reloaded_equal"] = all(
                torch.equal(a, b) for a, b in zip(fresh.params.values(), trainer.params.values())
            ) and all(
                torch.equal(fresh.optimizer.state[p][m], trainer.optimizer.state[q][m])
                for p, q in zip(fresh.params.values(), trainer.params.values()) for m in ("exp_avg", "exp_avg_sq")
            )
            res["moments"] = {
                name: trainer._to_model_layout(name, trainer.optimizer.state[p]["exp_avg"]).detach().numpy()
                for name, p in trainer.params.items()
            }
            grown = _grown(ds)
            n_old = (ds.n_users, ds.n_items)
            trainer.attach_dataset(grown)
            res["inductive"] = trainer.inductive_eval(*n_old)
        out[key] = res
        dist.barrier()
    return out


# -- the test side ------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_trainers"))


@pytest.fixture(scope="module")
def runs(workdir):
    return run_ranks(f"{__name__}:trainer_ranks", 2, workdir)


@pytest.fixture(scope="module")
def singles(tmp_path_factory):
    """The single-device trainers of the same configs and seed."""
    from inductive_recommendation_tpu_torch import get_model, get_trainer

    here = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("single_trainers"))
    try:
        out = {}
        for key, mcfg, tname, _, _ in CASES:
            ds = _dataset()
            trainer = get_trainer(dict(TRAINER, name=tname), ds, get_model(mcfg, ds, device="cpu"))
            losses, best = _run(trainer)
            out[key] = {"losses": losses, "best": best, "test": trainer.eval("test")[1], "trainer": trainer}
        return out
    finally:
        os.chdir(here)


def _assert_metrics_equal(got, want, tol=1e-6):
    for metric in want:
        for k, v in want[metric].items():
            assert abs(got[metric][k] - v) <= tol, (metric, k, got[metric][k], v)


@pytest.mark.parametrize("key", [c[0] for c in CASES])
def test_mesh_trainer_matches_single_device(runs, singles, key):
    ref = singles[key]
    for r in runs:
        got = r[key]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert abs(got["best"] - ref["best"]) <= 1e-6
        _assert_metrics_equal(got["test"], ref["test"])
    assert len(ref["losses"]) == 2 and runs[0][key]["rec"].shape == (150, 20)
    np.testing.assert_array_equal(runs[0][key]["rec"], runs[1][key]["rec"])


@pytest.mark.parametrize("key", [c[0] for c in CASES])
def test_mesh_checkpoint_loads_single_device(runs, key):
    """The best checkpoint holds the model's own layout: a single-device
    trainer loads it and gets the mesh trainer's test metrics."""
    from inductive_recommendation_tpu_torch import get_model, get_trainer

    _, mcfg, tname, _, _ = next(c for c in CASES if c[0] == key)
    got = runs[0][key]
    ds = _dataset()
    trainer = get_trainer(dict(TRAINER, name=tname), ds, get_model(mcfg, ds, device="cpu"))
    trainer._load_model(got["save_path"])
    _assert_metrics_equal(trainer.eval("test")[1], got["test"])
    for name, p in trainer.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), got["params"][name])
    assert got["alpha"] is None or trainer.model.alpha == got["alpha"]


def test_state_reshards_on_load(runs):
    """``save_state`` under the mesh writes the model's layout with the Adam
    moments gathered: a fresh mesh trainer re-shards it bit for bit, and a
    single-device trainer loads the same moments."""
    from inductive_recommendation_tpu_torch import get_model, get_trainer

    got = runs[0]["edge_igcn"]
    assert all(r["edge_igcn"]["reloaded_equal"] for r in runs)
    ds = _dataset()
    trainer = get_trainer(dict(TRAINER, name="IGCNTrainer"), ds, get_model(IGCN, ds, device="cpu"))
    trainer.load_state(got["state_path"])
    for name, p in trainer.params.items():
        np.testing.assert_array_equal(trainer.optimizer.state[p]["exp_avg"].numpy(), got["moments"][name])
    assert trainer.epoch == 2


def test_attach_dataset_and_inductive_eval(runs):
    """Under the mesh, ``attach_dataset`` rebuilds the sharded layouts around
    the grown set; ``inductive_eval`` equals a single-device model's with the
    same weights."""
    from inductive_recommendation_tpu_torch import get_model
    from inductive_recommendation_tpu_torch.eval import Evaluator
    from inductive_recommendation_tpu_torch.models import params_from_jax

    got = runs[0]["edge_igcn"]
    ds = _dataset()
    model = get_model(IGCN, ds, device="cpu")
    params = params_from_jax(model, got["params"])
    model.alpha = got["alpha"]
    grown = _grown(ds)
    model.attach_dataset(grown)
    want = Evaluator(grown, TRAINER["topks"], test_batch_size=64, device="cpu").inductive_eval(
        model, params, ds.n_users, ds.n_items, verbose=False
    )
    assert set(got["inductive"]) == set(want) and len(want) == 6
    for tag in want:
        _assert_metrics_equal(got["inductive"][tag], want[tag])
        assert runs[1]["edge_igcn"]["inductive"][tag] == got["inductive"][tag]


class _FakeMesh:
    """Enough of a mesh for the checks that run before any collective."""

    def size(self):
        return 2


@pytest.mark.parametrize("name", ["MF", "NeuMF", "MultiVAE", "ItemKNN", "Popularity"])
def test_edge_mode_refuses_other_families(name):
    """The models with no O(|E|) propagation to shard refuse edge mode and
    point at data mode."""
    from inductive_recommendation_tpu_torch import get_model, get_trainer

    ds = _dataset()
    cfg = dict(IGCN, name=name, dropout=0.1, layer_sizes=[16, 16], k=10)
    model = get_model(cfg, ds, device="cpu")
    with pytest.raises(ValueError, match="mesh_mode='data'"):
        get_trainer(dict(TRAINER, name="BPRTrainer"), ds, model, mesh=_FakeMesh(), mesh_mode="edge")


def _write_raw(path, seed=0, n_users=200, n_items=120, n_events=5000):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n_events):
        t = "2010-%02d-%02dT%02d:%02d:%02dZ" % (rng.integers(1, 13), rng.integers(1, 28), rng.integers(24),
                                                rng.integers(60), rng.integers(60))
        lines.append(f"{int(rng.integers(0, n_users))}\t{t}\t30.2\t-97.7\t{int(min(rng.zipf(1.6), n_items) - 1)}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "Gowalla_totalCheckins.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_cli_under_torchrun_matches_single_process(tmp_path, monkeypatch, capsys):
    """The grid's IGCN row for one epoch in edge mode on 2 ranks: rank 0
    prints the single-process run's JSON line, within 1e-5."""
    from inductive_recommendation_tpu_torch import main as cli

    _write_raw(tmp_path / "raw")
    monkeypatch.chdir(tmp_path)
    cli.main(["--preprocess", "gowalla", "--data-path", "raw", "--out-path", "data/Gowalla/time", "--min-inter", "3"])
    args = ["--grid", "gowalla", "--index", "2", "--n-epochs", "1", "--stage", "test", "--device", "cpu"]
    want = cli.main(args)
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "inductive_recommendation_tpu_torch", *args, "--mesh", "1,2", "--mesh-mode", "edge"],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [l for l in run.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1  # rank 0 prints
    got = json.loads(lines[0])
    assert got.keys() == want.keys() and got["model"] == "IGCN"
    for k in ("best_val_ndcg", "test_ndcg@20", "test_recall@20"):
        assert math.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert "mesh: {'data': 1, 'model': 2} over 2 ranks, edge mode" in run.stdout


def test_pad_like_and_table_align_match_jax(tmp_path):
    """Imported tables pad to a model's row-aligned shapes as the JAX
    package's ``pad_like`` pads them; ``--table-align`` pads a converted
    reference checkpoint to a multiple of a data-mode mesh's 'model' size."""
    from inductive_recommendation_tpu.train.import_reference import pad_like as jax_pad_like
    from inductive_recommendation_tpu_torch.train.checkpoint import load_checkpoint
    from inductive_recommendation_tpu_torch.train.import_reference import align_rows, main, pad_like

    rng = np.random.default_rng(2)
    params = {"embedding": rng.normal(size=(5, 3)).astype(np.float32), "w": rng.normal(size=3).astype(np.float32)}
    template = {"embedding": np.zeros((8, 3), np.float32), "w": np.zeros(3, np.float32)}
    got, want = pad_like(params, template), jax_pad_like(params, template)
    for k in params:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(align_rows(params, 4)["embedding"], got["embedding"])
    with pytest.raises(ValueError, match="does not fit"):
        pad_like({"embedding": np.zeros((9, 3), np.float32)}, template)
    src, dst = tmp_path / "ref.pth", tmp_path / "ref.ckpt"
    torch.save({"sate_dict": {"embedding.weight": torch.as_tensor(params["embedding"]), "w": torch.as_tensor(params["w"])},
                "user_map": {0: 0, 1: 1}, "item_map": {0: 0}, "alpha": 1.0}, src)
    main([str(src), str(dst), "--n-users", "2", "--n-items", "1", "--table-align", "4"])
    emb = load_checkpoint(dst)["params"]["embedding"].numpy()
    np.testing.assert_array_equal(emb, got["embedding"])


def test_table_align_pads_only_tables(tmp_path):
    """``--table-align`` pads the tables a data-mode mesh row-shards and no
    other leaf: a NeuMF reference checkpoint, whose MLP weight (6 x 5) is
    2-D and no table, converts to the shapes of a NeuMF built with 4-row
    alignment."""
    from inductive_recommendation_tpu_torch import get_model
    from inductive_recommendation_tpu_torch.train.checkpoint import load_checkpoint
    from inductive_recommendation_tpu_torch.train.import_reference import main

    ds = _dataset()
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    sd = {
        "mf_user_embedding.weight": t(ds.n_users, 8), "mf_item_embedding.weight": t(ds.n_items, 8),
        "mlp_user_embedding.weight": t(ds.n_users, 3), "mlp_item_embedding.weight": t(ds.n_items, 3),
        "mlp_layers.0.weight": t(5, 6), "mlp_layers.0.bias": t(5), "output_layer.weight": t(1, 13),
    }
    src, dst = tmp_path / "neumf.pth", tmp_path / "neumf.ckpt"
    torch.save(sd, src)
    main([str(src), str(dst), "--table-align", "4"])
    model = get_model({"name": "NeuMF", "embedding_size": 8, "layer_sizes": [6, 5], "table_align": 4}, ds, device="cpu")
    got = load_checkpoint(dst)["params"]
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(p.shape) for k, p in model.params().items()}
    assert ds.n_users % 4 and got["mf_user_embedding"].shape[0] == -(-ds.n_users // 4) * 4
    np.testing.assert_array_equal(got["mf_user_embedding"][: ds.n_users].numpy(), sd["mf_user_embedding.weight"].numpy())
    assert not got["mf_user_embedding"][ds.n_users :].any()
    np.testing.assert_array_equal(got["mlp_layers.0.w"].numpy(), sd["mlp_layers.0.weight"].T.numpy())
