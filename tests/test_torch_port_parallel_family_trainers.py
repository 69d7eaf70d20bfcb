"""The port's trainers of every family on a mesh: ``EdgeShardedTrainer``
for the DOSE variants, SGL, HALF, NGCF, IMCGAE, IDCF_LGCN and AttIGCN, and
data mode for the eight trainers of those families and of NeuMF and
MultiVAE, each 2 epochs (NeuMF 3, one a phase) in 2 gloo ranks with dropout
on, against the port's single-device trainer of the same seed (the same
init, batches, dropout masks and views, the views' refresh at the epoch end
included): epoch losses within 1e-5, test metrics within 1e-6.

Also: every family JAX's edge trainer accepts builds and steps in edge mode
(all 13 DOSE names) and every trainer in data mode; the best checkpoints of
a DOSE_aug and an AttIGCN edge run load into single-device trainers with
their test metrics; the saved state of a DOSE_aug, a TEST2 and an SGL edge
run replays their views and shards bit for bit in a fresh edge trainer;
DOSE_aug and AttIGCN edge runs attach a grown dataset and run the
inductive evaluation, equal to a single-device model's on their weights; data-mode DOSE_aug's first steps against the JAX
package's mesh trainer (``tests/test_trainer_mesh.py:89-128``) on JAX's
batches at dropout 0 (its steps' losses within 1e-5); and the command line
under ``torch.distributed.run`` with ``--mesh 1,2 --mesh-mode edge`` on the
Gowalla grid's DOSE_aug row against its single-process line (within 1e-5).

One module-scoped launch of 2 ranks (``parallel.launch.run_ranks``) runs
every mesh trainer; the single-device references run in the test process.
The trainers write ``checkpoints/`` in the working directory: a temporary
one per case.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0}
TRAINER = {"optimizer": "Adam", "lr": 5e-3, "l2_reg": 1e-4, "aux_reg": 0.01, "contrastive_reg": 0.1, "n_epochs": 2,
           "batch_size": 64, "test_batch_size": 64, "topks": [5, 20], "seed": 3, "kl_reg": 0.2,
           "mf_pretrain_epochs": 1, "mlp_pretrain_epochs": 1}
N_USERS, N_ITEMS, N_INTER = 80, 60, 1200
MODELS = {
    "DOSE_aug": {"aug_num": 100}, "DOSE_aug2": {"aug_num": 100}, "DOSE_aug3": {"aug_num": 100},
    "DOSE_aug4": {"aug_num": 100, "pai": 0.2}, "DOSE_drop": {"aug_num": 100}, "DOSE_drop2": {"aug_rate": 0.8},
    "DOSE_drop3": {"aug_num": 100}, "DOSE_aug_drop": {"aug_num": 100, "aug_rate": 0.8},
    "DOSE_aug_drop2": {"aug_num": 100}, "DOSE_aug_drop3": {"aug_num": 100}, "TEST": {"aug_rate": 0.8},
    "TEST2": {"aug_rate": 0.8}, "DOSE_test": {"aug_num": 100},
    "SGL": {"aug_rate": 0.8}, "HALF": {"aug_rate": 0.8}, "NGCF": {"layer_sizes": [16, 16], "dropout": 0.1},
    "IMCGAE": {}, "IDCF_LGCN": {"n_headers": 2, "n_samples": 10}, "AttIGCN": {"n_heads": 2},
    "LightGCN": {}, "IGCN": {}, "IMF": {"n_layers": 0},
    "MF": {}, "NeuMF": {"layer_sizes": [16, 8]}, "MultiVAE": {"layer_sizes": [32, 16], "dropout": 0.5},
}
TRAINER_OF = {
    "DOSE_aug": "DOSEaugTrainer", "DOSE_aug2": "DOSEaugTrainer", "DOSE_aug3": "DOSEaugTrainer",
    "DOSE_aug4": "DOSEaugTrainer", "DOSE_drop": "DOSEdropTrainer", "DOSE_drop2": "DOSEdropTrainer",
    "DOSE_drop3": "DOSEdropTrainer", "DOSE_aug_drop": "DOSEdropTrainer", "DOSE_aug_drop2": "DOSEdropTrainer",
    "DOSE_aug_drop3": "DOSEdropTrainer", "TEST": "DOSEtestTrainer", "TEST2": "DOSEtestTrainer",
    "DOSE_test": "DOSEtestTrainer", "SGL": "SGLTrainer", "HALF": "HALFTrainer", "NGCF": "BPRTrainer",
    "IMCGAE": "BPRTrainer", "IDCF_LGCN": "IDCFTrainer", "AttIGCN": "IGCNTrainer", "LightGCN": "BPRTrainer",
    "IGCN": "IGCNTrainer", "IMF": "IGCNTrainer", "MF": "BPRTrainer", "NeuMF": "BCETrainer", "MultiVAE": "MLTrainer",
}
EDGE_FAMILIES = [m for m in MODELS if m not in ("MF", "NeuMF", "MultiVAE")]
# (key, model, mesh shape, mode): trained 2 epochs and held to the single device
CASES = [(f"edge_{m}", m, (1, 2), "edge") for m in (
    "DOSE_aug", "DOSE_aug2", "DOSE_drop3", "DOSE_aug_drop", "DOSE_aug_drop2", "TEST", "TEST2", "DOSE_test", "SGL",
    "HALF", "NGCF", "IMCGAE", "IDCF_LGCN", "AttIGCN",
)] + [(f"data_{m}", m, (2, 1) if m in ("SGL", "NeuMF") else (1, 2), "data") for m in (
    "DOSE_aug", "DOSE_drop3", "DOSE_test", "SGL", "HALF", "IDCF_LGCN", "NeuMF", "MultiVAE",
)]
JAX_STEPS = 3
# edge runs whose state is saved and loaded by a fresh edge trainer
REPLAYED = ("edge_DOSE_aug", "edge_TEST2", "edge_SGL")
# edge runs that then attach a grown dataset and run the inductive evaluation
INDUCTIVE = ("edge_DOSE_aug", "edge_AttIGCN")


def _dataset():
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset

    return quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=1)


def _model(name, ds, **kw):
    from inductive_recommendation_tpu_torch import get_model

    cfg = dict(BASE, name=name, **MODELS[name], **kw)
    if name == "IDCF_LGCN":
        n = ds.n_users + ds.n_items
        cfg["pretrained_embedding"] = np.random.default_rng(5).normal(0, 0.1, (n, 16)).astype(np.float32)
    return get_model(cfg, ds, device="cpu")


def _trainer(name, ds, model, **mesh):
    from inductive_recommendation_tpu_torch import get_trainer

    n_epochs = 3 if name == "NeuMF" else TRAINER["n_epochs"]
    return get_trainer(dict(TRAINER, name=TRAINER_OF[name], n_epochs=n_epochs), ds, model, **mesh)


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


def trainer_ranks(workdir, jax_inputs):
    import torch
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch.parallel import make_mesh

    out = {"cases": {}, "built": {}}
    for key, name, shape, mode in CASES:
        os.makedirs(os.path.join(workdir, key), exist_ok=True)
        os.chdir(os.path.join(workdir, key))  # each run its own checkpoints/
        ds = _dataset()
        trainer = _trainer(name, ds, _model(name, ds), mesh=make_mesh(*shape), mesh_mode=mode)
        losses, best = _run(trainer)
        out["cases"][key] = {"losses": losses, "best": best, "test": trainer.eval("test")[1],
                             "save_path": os.path.abspath(trainer.save_path)}
        if key in REPLAYED:  # save_state, then a fresh edge trainer loads it: the same views, shards and weights
            state = os.path.join(workdir, f"{key}.state")
            trainer.save_state(state)
            fresh = _trainer(name, ds, _model(name, ds), mesh=make_mesh(*shape), mesh_mode=mode)
            fresh.load_state(state)
            out["cases"][key]["replayed"] = all(
                torch.equal(a.fwd.eid, b.fwd.eid) and torch.equal(a.fwd.val, b.fwd.val) and a.row_lo == b.row_lo
                for a, b in zip(trainer.view_shards, fresh.view_shards)
            ) and all(torch.equal(p, q) for p, q in zip(trainer.params.values(), fresh.params.values()))
        if key in INDUCTIVE:
            out["cases"][key]["params"] = {k: v.detach().numpy() for k, v in trainer._model_params().items()}
            out["cases"][key]["alpha"] = trainer.model.alpha
            trainer.attach_dataset(_grown(ds))
            out["cases"][key]["inductive"] = trainer.inductive_eval(ds.n_users, ds.n_items)
        dist.barrier()
    # every family in edge mode, every trainer in data mode: built and stepped
    ds = _dataset()
    for name in MODELS:
        for mode in ("edge", "data") if name in EDGE_FAMILIES else ("data",):
            trainer = _trainer(name, ds, _model(name, ds), mesh=make_mesh(1, 2), mesh_mode=mode)
            if name == "MultiVAE":
                users, valid, _ = trainer.batches(0)[0]
                loss = trainer.step(users, valid)
            else:
                loss = trainer.step()
            out["built"][(name, mode)] = (type(trainer).__name__, float(loss))
    # data-mode DOSE_aug on JAX's batches, from JAX's init, at dropout 0
    trainer = _trainer("DOSE_aug", ds, _model("DOSE_aug", ds, dropout=0.0), mesh=make_mesh(1, 2), mesh_mode="data")
    trainer._restore_params({k: torch.as_tensor(v) for k, v in jax_inputs["init"].items()})
    out["jax_losses"] = [float(trainer.step(*(torch.as_tensor(a) for a in b))) for b in jax_inputs["batches"]]
    return out


# -- the test side ------------------------------------------------------------------


def _jax_mesh_dose():
    """JAX's mesh DOSEaugTrainer on (2, 4): its init, the batches its first
    steps draw and their losses (at dropout 0 its model draws nothing)."""
    import jax

    from inductive_recommendation_tpu import get_model as jax_get_model
    from inductive_recommendation_tpu import get_trainer as jax_get_trainer
    from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
    from inductive_recommendation_tpu.data.sampling import sample_bpr_batch
    from inductive_recommendation_tpu.parallel import make_mesh

    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=1)
    cfg = dict(BASE, name="DOSE_aug", dropout=0.0, table_align=4, **MODELS["DOSE_aug"])
    tr = jax_get_trainer(dict(TRAINER, name="DOSEaugTrainer"), ds, jax_get_model(cfg, ds), mesh=make_mesh(2, 4))
    # the table's rows past the port model's (JAX aligns them to the mesh) are never read
    n_rows = N_USERS + N_ITEMS + 2
    init = {k: np.array(jax.device_get(v), np.float32)[:n_rows] for k, v in tr.params.items()}
    batches, losses = [], []
    for _ in range(JAX_STEPS):
        seed = tr._next_seed()
        r_s, r_a, _ = jax.random.split(jax.random.fold_in(jax.random.key(tr.seed), seed), 3)
        u, p, n = sample_bpr_batch(tr.sampler, r_s, tr.batch_size)
        au, ap, an = sample_bpr_batch(tr.aux_sampler, r_a, tr.batch_size)
        batches.append([np.asarray(a, np.int64) for a in (u, p, n[:, 0], au, ap, an[:, 0])])
        with tr.mesh:
            tr.params, tr.opt_state, loss = tr._step(tr.params, tr.opt_state, tr.model.buffers, tr.sampler,
                                                     tr.aux_sampler, seed)
        losses.append(float(loss))
    return {"init": init, "batches": batches}, losses


@pytest.fixture(scope="module")
def jax_mesh():
    return _jax_mesh_dose()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("family_trainers"))


@pytest.fixture(scope="module")
def runs(workdir, jax_mesh):
    return run_ranks(f"{__name__}:trainer_ranks", 2, workdir, jax_mesh[0])


@pytest.fixture(scope="module")
def singles(tmp_path_factory):
    """The single-device trainers of the same configs and seed."""
    here = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("single_family_trainers"))
    try:
        out = {}
        for key, name, _, _ in CASES:
            if key.startswith("data_") and f"edge_{name}" in out:
                out[key] = out[f"edge_{name}"]
                continue
            ds = _dataset()
            trainer = _trainer(name, ds, _model(name, ds))
            losses, best = _run(trainer)
            out[key] = {"losses": losses, "best": best, "test": trainer.eval("test")[1]}
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
        got = r["cases"][key]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert abs(got["best"] - ref["best"]) <= 1e-6
        _assert_metrics_equal(got["test"], ref["test"])
    assert len(ref["losses"]) == (3 if "NeuMF" in key else 2)


@pytest.mark.parametrize("key", REPLAYED)
def test_edge_state_replays_views(runs, key):
    """A fresh edge trainer loading a DOSE_aug / TEST2 / SGL edge run's state
    rebuilds the same views and their shards bit for bit, and the weights."""
    assert all(r["cases"][key]["replayed"] for r in runs)


@pytest.mark.parametrize("name", list(MODELS))
def test_every_family_builds_and_steps(runs, name):
    """Edge mode takes every family JAX's edge trainer takes; data mode
    every trainer."""
    built = runs[0]["built"]
    modes = ("edge", "data") if name in EDGE_FAMILIES else ("data",)
    for mode in modes:
        cls, loss = built[(name, mode)]
        assert math.isfinite(loss) and cls == ("EdgeShardedTrainer" if mode == "edge" else TRAINER_OF[name])
        assert all(r["built"][(name, mode)] == (cls, loss) for r in runs)


@pytest.mark.parametrize("name", ["DOSE_aug", "AttIGCN"])
def test_edge_checkpoint_loads_single_device(runs, name):
    """The best checkpoint of an edge run holds the model's own layout: a
    single-device trainer loads it and gets the edge trainer's test metrics."""
    got = runs[0]["cases"][f"edge_{name}"]
    ds = _dataset()
    trainer = _trainer(name, ds, _model(name, ds))
    trainer._load_model(got["save_path"])
    _assert_metrics_equal(trainer.eval("test")[1], got["test"])


@pytest.mark.parametrize("key", INDUCTIVE)
def test_edge_attach_dataset_and_inductive_eval(runs, key):
    """An edge run of DOSE_aug / AttIGCN attaches a grown dataset (the
    sharded layouts and views rebuilt around it) and its ``inductive_eval``
    equals a single-device model's with the same weights."""
    from inductive_recommendation_tpu_torch.eval import Evaluator
    from inductive_recommendation_tpu_torch.models import params_from_jax

    got = runs[0]["cases"][key]
    name = key.removeprefix("edge_")
    ds = _dataset()
    model = _model(name, ds)
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
        assert runs[1]["cases"][key]["inductive"][tag] == got["inductive"][tag]


def test_data_mode_dose_matches_jax_mesh_trainer(runs, jax_mesh):
    """Data-mode DOSEaugTrainer (1, 2) on the JAX mesh trainer's batches and
    init: the same step losses (its in-batch negatives gathered whole)."""
    _, want = jax_mesh
    for r in runs:
        np.testing.assert_allclose(r["jax_losses"], want, rtol=1e-5)
    assert len(want) == JAX_STEPS and np.isfinite(want).all()


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


def test_cli_dose_row_under_torchrun_matches_single_process(tmp_path, monkeypatch, capsys):
    """The Gowalla grid's DOSE_aug row (index 10) for one epoch in edge mode
    on 2 ranks: rank 0 prints the single-process run's JSON line."""
    from inductive_recommendation_tpu_torch import main as cli

    _write_raw(tmp_path / "raw")
    monkeypatch.chdir(tmp_path)
    cli.main(["--preprocess", "gowalla", "--data-path", "raw", "--out-path", "data/Gowalla/time", "--min-inter", "3"])
    args = ["--grid", "gowalla", "--index", "10", "--n-epochs", "1", "--stage", "test", "--device", "cpu"]
    want = cli.main(args)
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "inductive_recommendation_tpu_torch", *args, "--mesh", "1,2", "--mesh-mode", "edge"],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1  # rank 0 prints
    got = json.loads(lines[0])
    assert got.keys() == want.keys() and got["model"] == "DOSE_aug"
    for k in ("best_val_ndcg", "test_ndcg@20", "test_recall@20"):
        assert math.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert "mesh: {'data': 1, 'model': 2} over 2 ranks, edge mode" in run.stdout
