"""The PyTorch port's command line and run utilities against the JAX
package's ``main.py`` and trainer: ``--list``, ``--preprocess``, the ItemKNN
and IGCN rows of the Gowalla grid on the CPU, the summary writer's tags and
values, the train-split evaluation switch, SGD, and ``init_run``,
``AverageMeter``, ``nan_check``, ``StepTimer`` and ``trace``.

Both sides read the same files, written from numpy seeds. The ItemKNN row
(no training) must print JSON values within 1e-6 of JAX's; the writer's
values, with both trainers fed the same batches, within 1e-5; one SGD step
within 1e-6 of ``optax.sgd``. The trainer writes ``checkpoints/`` in the
working directory, so the tests run in ``tmp_path``."""

import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inductive_recommendation_tpu import get_dataset as jax_get_dataset
from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu import get_trainer as jax_get_trainer
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch import get_dataset, get_model, get_trainer
from inductive_recommendation_tpu_torch import main as cli
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.train import AverageMeter, OPTIMIZERS
from inductive_recommendation_tpu_torch.train import trainer as trainer_module
from inductive_recommendation_tpu_torch.utils import StepTimer, init_run, nan_check, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = ["gowalla", "yelp", "amazon", "alibaba", "ml"]


def jax_main():
    spec = importlib.util.spec_from_file_location("jax_main_cli", os.path.join(ROOT, "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_gowalla(path, seed=0, n_users=200, n_items=120, n_events=5000):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n_events):
        u = int(rng.integers(0, n_users))
        i = int(min(rng.zipf(1.6), n_items) - 1)
        t = "2010-%02d-%02dT%02d:%02d:%02dZ" % (rng.integers(1, 13), rng.integers(1, 28), rng.integers(24),
                                                rng.integers(60), rng.integers(60))
        lines.append(f"{u}\t{t}\t30.2\t-97.7\t{i}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "Gowalla_totalCheckins.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture
def work(tmp_path, monkeypatch):
    """A working directory holding the Gowalla grid's ``data/Gowalla/time``,
    written by the port's preprocessing of a small raw file."""
    write_gowalla(tmp_path / "raw")
    monkeypatch.chdir(tmp_path)
    cli.main(["--preprocess", "gowalla", "--data-path", "raw", "--out-path", "data/Gowalla/time", "--min-inter", "3"])
    return tmp_path


@pytest.mark.parametrize("grid", GRIDS)
def test_list_matches_jax_main(grid, capsys):
    jax_main().main(["--grid", grid, "--list"])
    want = capsys.readouterr().out
    assert cli.main(["--grid", grid, "--list"]) is None
    assert capsys.readouterr().out == want
    assert want.count("\n") >= 5


def test_help_lists_main_arguments(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    port = capsys.readouterr().out
    with pytest.raises(SystemExit):
        jax_main().main(["--help"])
    ref = capsys.readouterr().out
    flags = {tok.rstrip(",") for tok in ref.split() if tok.startswith("--")}
    assert {f for f in flags if f not in ("--mesh", "--mesh-mode")} <= set(port.split())
    options = cli.build_argparser()._option_string_actions
    assert "--device" in options and "--mesh" not in options and "--mesh-mode" not in options
    assert "--mesh-mode" in port and "multi-GPU slice" in cli.build_argparser().epilog


@pytest.mark.parametrize("split", [[0.7, 0.1, 0.2], [0.8, 0.1, 0.1]])
def test_preprocess_writes_jax_files(tmp_path, split):
    write_gowalla(tmp_path / "raw", seed=3)
    args = ["--preprocess", "gowalla", "--data-path", str(tmp_path / "raw"), "--min-inter", "4",
            "--split", *map(str, split)]
    ds = cli.main(args + ["--out-path", str(tmp_path / "port" / "time")])
    jax_main().main(args + ["--out-path", str(tmp_path / "jax")])
    for name in ("train", "val", "test"):
        assert (tmp_path / "port" / "time" / f"{name}.txt").read_bytes() == (tmp_path / "jax" / f"{name}.txt").read_bytes()
    assert ds.n_users > 10


def test_itemknn_row_matches_jax(work, capsys):
    """Index 3 of the Gowalla grid: ItemKNN (k 1,000, more than the set's
    items, so no neighbour is cut) evaluated on the test split. The set is
    dense enough that no tie of scores decides a rank (a tie's order is
    each side's own)."""
    args = ["--grid", "gowalla", "--index", "3", "--stage", "test"]
    jax_main().main(args)
    want = last_json(capsys.readouterr().out)
    got = cli.main(args + ["--device", "cpu"])
    assert last_json(capsys.readouterr().out) == got
    assert got.keys() == want.keys() and got["model"] == "ItemKNN"
    for k in ("best_val_ndcg", "test_ndcg@20", "test_recall@20"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["test_ndcg@20"] > 0


def test_igcn_row_one_epoch_with_inductive(work, capsys):
    ds = get_dataset({"name": "ProcessedDataset", "path": "data/Gowalla/time"})
    n_old = [str(int(0.9 * ds.n_users)), str(int(0.9 * ds.n_items))]
    got = cli.main(["--grid", "gowalla", "--index", "2", "--n-epochs", "1", "--stage", "test", "--device", "cpu",
                    "--inductive", *n_old])
    out = capsys.readouterr().out
    assert last_json(out) == got
    assert list(got) == ["model", "trainer", "best_val_ndcg", "test_ndcg@20", "test_recall@20"]
    assert got["model"] == "IGCN" and got["trainer"] == "IGCNTrainer"
    assert all(math.isfinite(got[k]) for k in ("best_val_ndcg", "test_ndcg@20", "test_recall@20"))
    for tag in ("All users and all items", "New users and all items", "Old users and old items"):
        assert f"{tag} result." in out
    assert len(os.listdir("checkpoints")) == 1


def test_log_path_redirects_output(work, monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    got = cli.main(["--grid", "gowalla", "--index", "3", "--device", "cpu", "--log-path", "logs"])
    sys.stdout.flush()
    text = (work / "logs" / "lo00gg.txt").read_text()
    assert last_json(text) == got


def test_writer_needs_tensorboard(work, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(SystemExit, match="tensorboard"):
        cli.main(["--grid", "gowalla", "--index", "3", "--device", "cpu", "--writer"])


# -- the trainer loop's writer and flags, against the JAX trainer ------------------


class FakeWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


SYN = {"name": "SyntheticDataset", "n_users": 30, "n_items": 25, "n_interactions": 400, "seed": 1,
       "split_ratio": [0.8, 0.1, 0.1], "min_inter": 2}


def _mf_trainer_cfg(**kw):
    cfg = {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-2, "l2_reg": 1e-4, "n_epochs": 2, "batch_size": 64,
           "test_batch_size": 16, "topks": [1, 5, 10, 15, 20, 25], "val_interval": 1, "seed": 0}
    cfg.update(kw)
    return cfg


def _batches(ds, n, batch, seed):
    rng = np.random.default_rng(seed)
    users = np.flatnonzero([len(t) > 0 for t in ds.train_data])
    out = []
    for _ in range(n):
        u = users[rng.integers(0, len(users), batch)]
        p = np.array([ds.train_data[x][rng.integers(len(ds.train_data[x]))] for x in u])
        out.append((u, p, rng.integers(0, ds.n_items, batch)))
    return out


def _feed(monkeypatch, batches):
    it = iter(batches)

    def fake(state, generator, batch_size, neg_ratio=1):
        u, p, n = next(it)
        return torch.as_tensor(u), torch.as_tensor(p), torch.as_tensor(n)[:, None]

    monkeypatch.setattr(trainer_module, "sample_bpr_batch", fake)


def _jax_bpr_step(jm, optimizer, l2_reg):
    def step(params, opt_state, users, pos, neg):
        def loss_fn(p):
            u_r, p_r, n_r, l2 = jm.bpr_forward(p, users, pos, neg, training=False, buffers=jm.buffers)
            return JL.bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jax.jit(step)


def test_writer_records_match_jax(tmp_path, monkeypatch):
    """MF with BPRTrainer for 2 epochs on both sides, fed the same batches:
    the JAX trainer's own loop (its epoch replaced by optax steps on those
    batches) and the port's record the same tags, steps and values."""
    monkeypatch.chdir(tmp_path)
    cfg = _mf_trainer_cfg()
    jds, pds = jax_get_dataset(SYN), get_dataset(SYN)
    jt = jax_get_trainer(cfg, jds, jax_get_model({"name": "MF", "embedding_size": 8}, jds))
    pt = get_trainer(cfg, pds, get_model({"name": "MF", "embedding_size": 8}, pds, device="cpu"))
    params_from_jax(pt.model, jt.params)
    epochs = [_batches(pds, pt.steps_per_epoch, 64, seed) for seed in range(cfg["n_epochs"])]
    assert pt.steps_per_epoch == jt.steps_per_epoch
    step = _jax_bpr_step(jt.model, jt.optimizer, cfg["l2_reg"])

    def jax_epoch():
        losses = []
        for u, p, n in epochs[jt.epoch]:
            jt.params, jt.opt_state, loss = step(jt.params, jt.opt_state, *map(jnp.asarray, (u, p, n)))
            losses.append(float(loss))
        return float(np.mean(losses))

    jt.train_one_epoch = jax_epoch
    want, got = FakeWriter(), FakeWriter()
    jt.train(verbose=False, writer=want)
    _feed(monkeypatch, [b for e in epochs for b in e])
    pt.train(verbose=False, writer=got)
    assert [(t, s) for t, _, s in got.scalars] == [(t, s) for t, _, s in want.scalars]
    for (tag, g, _), (_, w, _) in zip(got.scalars, want.scalars):
        assert abs(g - w) <= 1e-5, (tag, g, w)
    tags = {t for t, _, _ in got.scalars}
    assert {"MF_BPRTrainer/train_loss", "MF_BPRTrainer/validation_NDCG@20", "MF_BPRTrainer/train_Recall@5"} <= tags


def _count_stages(trainer):
    stages = []
    orig = trainer.eval

    def spy(stage, banned_items=None):
        stages.append(stage)
        return orig(stage, banned_items=banned_items)

    trainer.eval = spy
    return stages


@pytest.mark.parametrize("flag, writer, n_train", [(False, False, 0), (True, False, 2), (False, True, 2)])
def test_train_split_eval_count(tmp_path, monkeypatch, flag, writer, n_train):
    """As tests/test_trainer_flags.py: the train split is evaluated once an
    epoch only when ``eval_train_every_epoch`` or a writer asks for it."""
    monkeypatch.chdir(tmp_path)
    ds = get_dataset(SYN)
    trainer = get_trainer(_mf_trainer_cfg(eval_train_every_epoch=flag, topks=[1, 5, 10]), ds,
                          get_model({"name": "MF", "embedding_size": 8}, ds, device="cpu"))
    stages = _count_stages(trainer)
    trainer.train(verbose=False, writer=FakeWriter() if writer else None)
    assert stages.count("train") == n_train and stages.count("val") == 2


def test_sgd_step_matches_optax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert set(OPTIMIZERS) == {"Adam", "SGD"}
    cfg = _mf_trainer_cfg(optimizer="SGD", lr=0.5)
    jds, pds = jax_get_dataset(SYN), get_dataset(SYN)
    jm = jax_get_model({"name": "MF", "embedding_size": 8}, jds)
    jp = jm.init_params(jax.random.key(2))
    pt = get_trainer(cfg, pds, get_model({"name": "MF", "embedding_size": 8}, pds, device="cpu"))
    params_from_jax(pt.model, jp)
    assert isinstance(pt.optimizer, torch.optim.SGD)
    (batch,) = _batches(pds, 1, 64, seed=5)
    _feed(monkeypatch, [batch])
    optimizer = optax.sgd(0.5)
    jp, _, j_loss = _jax_bpr_step(jm, optimizer, cfg["l2_reg"])(jp, optimizer.init(jp), *map(jnp.asarray, batch))
    loss = pt.step()
    assert abs(loss.item() - float(j_loss)) <= 1e-6
    for k, v in pt.params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


# -- run utilities ---------------------------------------------------------------------


def test_init_run_and_meter(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    init_run(str(tmp_path / "run"), 3)
    print("to the log")
    a = np.random.rand()
    sys.stdout.flush()
    assert (tmp_path / "run" / "lo00gg.txt").read_text() == "to the log\n"
    np.random.seed(3)
    assert np.random.rand() == a
    meter = AverageMeter()
    for v, n in ((1.0, 1), (4.0, 3)):
        meter.update(v, n)
    assert (meter.sum, meter.count, meter.avg) == (13.0, 4, 3.25)


def test_nan_check_timer_and_trace(tmp_path):
    tree = {"a": torch.ones(3), "layers": [{"w": torch.tensor([1.0, float("nan")])}, {"w": torch.zeros(2)}],
            "ids": torch.arange(3), "b": np.array([np.inf])}
    assert nan_check(tree, "params") == ["params.layers.0.w", "params.b"]
    assert nan_check({"a": torch.ones(2)}) == []
    timer = StepTimer()
    with trace(str(tmp_path / "trace")):
        for _ in range(3):
            timer.start()
            out = torch.ones(64, 64) @ torch.ones(64, 64)
            timer.stop(out)
    assert len(timer.times) == 3 and timer.p50_ms > 0 and timer.mean_ms > 0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
