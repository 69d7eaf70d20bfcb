"""Edge mode as a placement of the named trainer (``parallel/placement.py``).

A model defined only here, an ``IGCN`` whose ``bpr_forward`` adds one L2
term (on the auxiliary weight ``w``), trains in edge mode with no edge code
of its own: ``IGCNTrainer`` under the edge placement at mesh (1, 1) and
(1, 2), dropout on, two epochs, against the same trainer on one device in
the same process (same seed: same init, batches, dropout masks). At world 1
the shard is the whole layout, its transpose the whole layout's, and the
losses are the single-device ones bit for bit; at world 2 within 1e-5.

And the direction of the imports: ``parallel/`` -> ``models/`` -> ``ops/``;
no module under ``models/`` or ``ops/`` imports the edge placement, and no
module under ``models/`` imports ``parallel/`` at all.
"""

import ast
import os

import numpy as np
import pytest

from inductive_recommendation_tpu_torch.models import IGCN
from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "inductive_recommendation_tpu_torch")
MODEL = {"name": "WL2IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0}
TRAINER = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 5e-3, "l2_reg": 1e-3, "aux_reg": 0.01, "n_epochs": 2,
           "batch_size": 64, "test_batch_size": 64, "topks": [20], "seed": 5}
W_REG = 0.05


class WL2IGCN(IGCN):
    """IGCN with ``W_REG * ||w||^2`` in every sample's L2 term."""

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        users_r, pos_r, neg_r, l2 = super().bpr_forward(params, users, pos_items, neg_items, training, generator)
        return users_r, pos_r, neg_r, l2 + W_REG * (params["w"] ** 2).sum()


def _losses(trainer):
    losses = []
    for _ in range(TRAINER["n_epochs"]):
        losses.append(trainer.train_one_epoch())
    return losses


def new_model_ranks(workdir):
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch import get_trainer
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset
    from inductive_recommendation_tpu_torch.parallel import make_mesh

    os.chdir(workdir)
    ds = quick_synthetic_dataset(70, 50, 900, seed=2)
    single = get_trainer(TRAINER, ds, WL2IGCN(MODEL, ds, "cpu"))
    edge = get_trainer(TRAINER, ds, WL2IGCN(MODEL, ds, "cpu"), mesh=make_mesh(1, dist.get_world_size()),
                       mesh_mode="edge")
    return {"single": _losses(single), "edge": _losses(edge), "cls": type(edge).__name__,
            "test": edge.eval("test")[1]["NDCG"][20], "single_test": single.eval("test")[1]["NDCG"][20]}


@pytest.mark.parametrize("world", [1, 2])
def test_a_new_model_trains_in_edge_mode_with_no_edge_code(tmp_path, world):
    runs = run_ranks(f"{__name__}:new_model_ranks", world, str(tmp_path))
    for r in runs:
        assert r["cls"] == "IGCNTrainer" and len(r["edge"]) == TRAINER["n_epochs"] and np.isfinite(r["edge"]).all()
        if world == 1:
            assert r["edge"] == r["single"]
            assert r["test"] == r["single_test"]
        else:
            np.testing.assert_allclose(r["edge"], r["single"], rtol=1e-5)
            assert abs(r["test"] - r["single_test"]) <= 1e-6
    assert r["single"][0] != pytest.approx(r["single"][1], rel=1e-4)  # it trained


def direct_attach_ranks(workdir):
    """One epoch each of IGCN on one device and in edge mode; then the grown
    dataset attached to each model directly, not through its trainer, and
    each trainer's inductive evaluation and one more epoch."""
    import torch.distributed as dist
    from test_torch_port_parallel_trainers import _grown

    from inductive_recommendation_tpu_torch import get_model, get_trainer
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset
    from inductive_recommendation_tpu_torch.parallel import make_mesh

    os.chdir(workdir)
    ds = quick_synthetic_dataset(70, 50, 900, seed=2)
    grown = _grown(ds)
    cfg = dict(MODEL, name="IGCN")
    single = get_trainer(TRAINER, ds, get_model(cfg, ds, device="cpu"))
    edge = get_trainer(TRAINER, ds, get_model(cfg, ds, device="cpu"), mesh=make_mesh(1, dist.get_world_size()),
                       mesh_mode="edge")
    out = {}
    for key, trainer in (("single", single), ("edge", edge)):
        trainer.train_one_epoch()
        trainer.model.attach_dataset(grown)
        out[key] = {"inductive": trainer.inductive_eval(ds.n_users, ds.n_items), "bound": trainer.dataset is grown,
                    "steps": trainer.steps_per_epoch, "loss": trainer.train_one_epoch()}
    out["want_steps"] = -(-len(grown) // TRAINER["batch_size"])
    return out


def test_a_direct_attach_is_followed_in_edge_mode(tmp_path):
    """``model.attach_dataset(grown)`` called on the model, not the trainer:
    the trainer rebinds its evaluator and samplers to the grown set before
    it evaluates, in edge mode at world 2 as on one device, and the
    inductive metrics agree."""
    for r in run_ranks(f"{__name__}:direct_attach_ranks", 2, str(tmp_path)):
        single, edge = r["single"], r["edge"]
        for side in (single, edge):
            assert side["bound"] and side["steps"] == r["want_steps"] and np.isfinite(side["loss"])
        assert set(edge["inductive"]) == set(single["inductive"]) and len(single["inductive"]) == 6
        for tag, metrics in single["inductive"].items():
            for name, by_k in metrics.items():
                for k, value in by_k.items():
                    assert abs(edge["inductive"][tag][name][k] - value) <= 1e-6, (tag, name, k)


def route_ranks():
    """The routes of every product edge mode runs for AttIGCN, DOSE_aug2 (its
    augmented feature matrix made at the epoch end) and NGCF, dropout on,
    over steps and an evaluation, recorded where the products run."""
    from inductive_recommendation_tpu_torch import get_model, get_trainer
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset
    from inductive_recommendation_tpu_torch.ops import csr_spmm
    from inductive_recommendation_tpu_torch.parallel import make_mesh
    from inductive_recommendation_tpu_torch.parallel import spmm as parallel_spmm

    routes, product = set(), csr_spmm._product

    def recorded(mat, x, edge_scale=None, drop=None):
        routes.add(csr_spmm.route_key(mat, drop))
        return product(mat, x, edge_scale, drop)

    csr_spmm._product = parallel_spmm._product = recorded
    ds = quick_synthetic_dataset(40, 30, 400, seed=3)
    for name, extra, trainer in (("AttIGCN", {"n_heads": 2}, "IGCNTrainer"), ("DOSE_aug2", {"aug_num": 20},
                                 "DOSEaugTrainer"), ("NGCF", {"layer_sizes": [8, 8]}, "BPRTrainer")):
        cfg = dict(MODEL, name=name, embedding_size=8, **extra)
        t = get_trainer(dict(TRAINER, name=trainer, contrastive_reg=0.1), ds, get_model(cfg, ds, device="cpu"),
                        mesh=make_mesh(1, 1), mesh_mode="edge")
        t.step()
        t.epoch_end()
        t.step()
        t.eval("val")
    return sorted(routes)


def test_every_edge_route_is_counted():
    """The kernel's launch counter knows every route an edge-mode product
    counts under (the query's and the augmented feature matrix's shards
    included): on the card an unknown route stops the step."""
    from inductive_recommendation_tpu_torch.ops.csr_spmm import ROUTES

    (routes,) = run_ranks(f"{__name__}:route_ranks", 1)
    assert {"edge_shard_dropout", "edge_shard_attention", "edge_shard_attention_query",
            "edge_shard_aug_feat_dropout", "edge_shard_view"} <= set(routes)
    assert set(routes) <= set(ROUTES), sorted(set(routes) - set(ROUTES))


def _imports(path):
    """The modules ``path`` imports, at its top or inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"
        elif isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)


@pytest.mark.parametrize("package", ["models", "ops"])
def test_models_and_ops_do_not_import_the_edge_placement(package):
    """The placement's direction: ``parallel/`` builds on ``models/``, which
    builds on ``ops/``; the local placement lives in ``models/``."""
    files = [os.path.join(PORT, package, f) for f in sorted(os.listdir(os.path.join(PORT, package)))
             if f.endswith(".py")]
    assert files
    for path in files:
        imported = set(_imports(path))
        assert not any(m.startswith("inductive_recommendation_tpu_torch.parallel.placement") for m in imported), path
        if package == "models":
            assert not any(m.startswith("inductive_recommendation_tpu_torch.parallel") for m in imported), path
