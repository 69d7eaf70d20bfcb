"""The bookkeeping of the training step replayed as a CUDA graph
(``train/step_graph.py``), on the CPU, where a stand-in takes the CUDA
graph's place.

The stand-in's capture runs the forward and backward's Python once, as a
capture does (the wrappers, the launch counters, the seed table's entries
handed out; it leaves only gradients, which a replay writes again); its
replay runs them again with the seed table's entries as the seeds
(the CPU product reads an entry's value when it runs, as the kernel reads
its address) and writes the loss into the captured one, its own counting
taken back (a replay calls no wrapper). Held here: the seeds a warm-up
step, a capture and its replays use, against the stream of a CPU generator
seeded with the trainer's seed, as the benchmark's reference draws them;
losses and parameters bit for bit those of the eager trainer, across an
epoch end; the launch counters, one step's growth a step; the graph dropped
at an epoch end, ``attach_dataset``, ``load_state``, ``initialize_optimizer``
and when the model rebinds a layout; who builds one."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu_torch.ops import attention_csr, csr_spmm
from inductive_recommendation_tpu_torch.ops.csr_spmm import SeedTable, route_key, spmm_csr_cuda
from inductive_recommendation_tpu_torch.train import step_graph
from inductive_recommendation_tpu_torch.train.step_graph import StepGraph, add_launch_counts, launch_counts
from port_bench.core.reference import dropout_seeds

IGCN = {"name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0}
MODELS = {
    "IGCN": (IGCN, "IGCNTrainer"),
    "DOSE_aug": (dict(IGCN, name="DOSE_aug", aug_num=40), "DOSEaugTrainer"),
    "AttIGCN": (dict(IGCN, name="AttIGCN", n_heads=2), "IGCNTrainer"),
}
TRAINER = {"optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01, "contrastive_reg": 0.05,
           "n_epochs": 1, "batch_size": 64, "test_batch_size": 32, "topks": [5, 20], "seed": 3}
SEEDS_A_STEP = {"IGCN": 1, "DOSE_aug": 2, "AttIGCN": 0}


@pytest.fixture(scope="module")
def dataset():
    return quick_synthetic_dataset(70, 90, 1500, seed=5)


def make_trainer(dataset, name="IGCN", graph=True):
    """The named model's trainer on the CPU; with ``graph``, its step
    through a ``StepGraph`` (the stand-in's, :func:`stand_in`)."""
    model_cfg, trainer_name = MODELS[name]
    model = get_model(dict(model_cfg), dataset, device="cpu")
    trainer = get_trainer(dict(TRAINER, name=trainer_name), dataset, model)
    assert trainer.step_graph is None  # never on the CPU by itself
    if graph:
        trainer.step_graph = StepGraph(trainer)
    return trainer


class StandInGraph:
    """A CUDA graph's CPU stand-in (the module's docstring)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out
        self.replays = 0

    def replay(self):
        before = launch_counts()
        self.out.copy_(self.fn())
        after = launch_counts()
        add_launch_counts({k: n - before.get(k, 0) for k, n in after.items()}, -1)
        self.replays += 1


def stand_in(monkeypatch):
    """Installs the stand-in's capture and warm-up; returns the graphs it
    made."""
    graphs = []

    def capture(fn, stream):
        _capturing.append(True)
        try:
            out = fn()
        finally:
            _capturing.pop()
        graphs.append(StandInGraph(fn, out))
        return graphs[-1], out

    monkeypatch.setattr(step_graph, "_capture", capture)
    monkeypatch.setattr(step_graph, "_warm_up", lambda fn, stream: fn())
    return graphs


# True while the stand-in's capture runs the step's Python
_capturing = []


def counting(monkeypatch):
    """The CPU products counted as the kernels count theirs: two launches a
    product under its route, one for every attention op by its plain route."""
    product = csr_spmm._product

    def counted(mat, x, edge_scale=None, drop=None):
        spmm_csr_cuda.launches += 2
        spmm_csr_cuda.route_launches[route_key(mat, drop)] += 2
        return product(mat, x, edge_scale, drop)

    monkeypatch.setattr(csr_spmm, "_product", counted)
    monkeypatch.setattr(attention_csr, "_product", counted, raising=False)
    run = attention_csr._run

    def counted_run(tensors, reference, cuda):
        attention_csr._count("plain", "attention")
        return run(tensors, reference, cuda)

    monkeypatch.setattr(attention_csr, "_run", counted_run)


def seeds_used(monkeypatch) -> tuple[list, list]:
    """The seeds of the dropout products that run (not in a capture): the
    forward ones and the transposes of the backward, in order."""
    forward, transpose, product = [], [], csr_spmm._product

    def recorded(mat, x, edge_scale=None, drop=None):
        if drop is not None and not _capturing:
            (transpose if mat.transposed else forward).append(int(drop[0]))
        return product(mat, x, edge_scale, drop)

    monkeypatch.setattr(csr_spmm, "_product", recorded)
    return forward, transpose


@pytest.mark.parametrize("name", ["IGCN", "DOSE_aug"])
def test_the_seeds_of_a_warm_up_a_capture_and_replays_are_the_generators_stream(dataset, monkeypatch, name):
    trainer = make_trainer(dataset, name)
    graphs = stand_in(monkeypatch)
    forward, transpose = seeds_used(monkeypatch)
    for _ in range(7):  # the warm-up, the capture and its replay, five replays
        trainer.step()
    (graph,) = graphs
    n = SEEDS_A_STEP[name]
    assert graph.replays == 6 and trainer.step_graph.n_seeds == n
    stream = dropout_seeds(TRAINER["seed"])
    assert forward == [next(stream) for _ in range(7 * n)]
    # the backward drops the same edges: each step's seeds again, in any order
    assert [sorted(transpose[i : i + n]) for i in range(0, 7 * n, n)] == \
        [sorted(forward[i : i + n]) for i in range(0, 7 * n, n)]


@pytest.mark.parametrize("name", ["IGCN", "DOSE_aug", "AttIGCN"])
def test_losses_and_parameters_equal_the_eager_steps_across_an_epoch_end(dataset, monkeypatch, name):
    eager, graphed = make_trainer(dataset, name, graph=False), make_trainer(dataset, name)
    graphs = stand_in(monkeypatch)
    for trainer in (eager, graphed):
        trainer.steps_per_epoch = 5
    losses = {}
    for key, trainer in (("eager", eager), ("graph", graphed)):
        kept, step = [], trainer.step

        def recorded(*batch, _step=step, _kept=kept):
            _kept.append(_step(*batch))
            return _kept[-1]

        trainer.step = recorded
        epochs = [trainer.train_one_epoch() for _ in range(2)]
        kept += [trainer.step() for _ in range(3)]  # into the third epoch
        losses[key] = (epochs, torch.stack(kept))
    assert len(graphs) == 3  # one capture an epoch
    assert losses["graph"][0] == losses["eager"][0]
    assert torch.equal(losses["graph"][1], losses["eager"][1])
    for k in eager.params:
        assert torch.equal(graphed.params[k], eager.params[k]), k
    assert eager.model.alpha == graphed.model.alpha


@pytest.mark.parametrize("name", ["IGCN", "AttIGCN"])
def test_the_counters_count_one_steps_launches_a_step(dataset, monkeypatch, name):
    counting(monkeypatch)
    eager = make_trainer(dataset, name, graph=False)
    eager.step()
    before = launch_counts()
    eager.step()
    one = {k: n - before.get(k, 0) for k, n in launch_counts().items() if n != before.get(k, 0)}
    assert one["spmm_csr"] > 0 and (name != "AttIGCN" or one["attention_csr/plain/attention"] > 0)

    trainer = make_trainer(dataset, name)
    stand_in(monkeypatch)
    for i in range(5):  # the warm-up, the capture and its replay, three replays
        before = launch_counts()
        trainer.step()
        grown = {k: n - before.get(k, 0) for k, n in launch_counts().items() if n != before.get(k, 0)}
        assert grown == one, i
    assert trainer.step_graph.growth == one


def _captured(trainer):
    for _ in range(2):
        trainer.step()
    assert trainer.step_graph.graph is not None


def test_each_rebind_drops_the_graph(dataset, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    trainer = make_trainer(dataset)
    stand_in(monkeypatch)
    graph = trainer.step_graph

    _captured(trainer)
    trainer.steps_per_epoch = 3
    trainer.train_one_epoch()  # its epoch end drops the graph captured in it
    assert graph.graph is None and not graph.warm

    _captured(trainer)
    trainer.attach_dataset(dataset)
    assert graph.graph is None

    _captured(trainer)
    trainer.save_state(tmp_path / "state.pt")
    trainer.step()
    trainer.load_state(tmp_path / "state.pt")
    assert graph.graph is None

    _captured(trainer)
    trainer.initialize_optimizer()
    assert graph.graph is None and all(p.grad is None for p in trainer.params.values())

    # a layout the model rebinds by itself: the next step finds the graph
    # stale and runs eagerly
    _captured(trainer)
    trainer.model.feat_mat_anneal()
    eager_steps = []
    monkeypatch.setattr(type(trainer), "eager_step",
                        lambda self, batch, _real=type(trainer).eager_step: eager_steps.append(1) or _real(self, batch))
    trainer.step()
    assert graph.graph is None and graph.warm and eager_steps == [1]


def test_a_resumed_graph_trainer_steps_as_the_uninterrupted_one(dataset, monkeypatch, tmp_path):
    """``load_state`` mid-run: the graph trainer drops its graph, and its next
    steps equal those of the uninterrupted eager run bit for bit."""
    monkeypatch.chdir(tmp_path)
    stand_in(monkeypatch)
    a, b = make_trainer(dataset, graph=False), make_trainer(dataset)
    for _ in range(4):
        a.step()
    a.save_state(tmp_path / "state.pt")
    _captured(b)
    b.load_state(tmp_path / "state.pt")
    la = torch.stack([a.step() for _ in range(4)])
    lb = torch.stack([b.step() for _ in range(4)])
    assert torch.equal(la, lb)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


def test_who_replays(dataset):
    """On a CUDA device with no mesh, the IGCN family; never on the CPU,
    under a mesh, or for a model that says it stays eager."""
    igcn = get_model(dict(IGCN), dataset, device="cpu")
    ngcf = get_model({"name": "NGCF", "embedding_size": 16, "layer_sizes": [16, 16], "dropout": 0.1}, dataset,
                     device="cpu")
    assert step_graph.replays(igcn, "cuda", None)
    assert not step_graph.replays(igcn, "cpu", None)
    assert not step_graph.replays(igcn, "cuda", object())
    assert not ngcf.graph_step and not step_graph.replays(ngcf, "cuda", None)
    assert make_trainer(dataset, graph=False).step_graph is None


def test_a_seed_table_hands_out_its_entries_and_draws_nothing():
    """From a ``SeedTable`` the forward draws nothing: it takes the table's
    entries in order, and refuses more than the table holds; from a
    generator, an integer."""
    table = SeedTable(3, "cpu")
    table.values.copy_(torch.arange(3))
    seeds = [csr_spmm.dropout_seed(table) for _ in range(3)]
    with pytest.raises(RuntimeError, match="more than 3"):
        csr_spmm.dropout_seed(table)
    assert table.taken == 3 and [int(s) for s in seeds] == [0, 1, 2]
    assert all(s.data_ptr() == table.values[i].data_ptr() for i, s in enumerate(seeds))
    assert isinstance(csr_spmm.dropout_seed(torch.Generator().manual_seed(1)), int)


def test_a_seed_in_the_table_drops_the_edges_its_value_drops(dataset):
    """The CPU product under a table entry equals the product under the
    entry's integer value."""
    model = get_model(dict(IGCN), dataset, device="cpu")
    x = torch.randn(model.feat_n_cols, 16, generator=torch.Generator().manual_seed(0))
    table = torch.tensor([12345, 2**62 - 7], dtype=torch.int64)
    for i in range(2):
        want = csr_spmm.spmm_csr_dropout(model.feat, x, int(table[i]), 0.3)
        assert torch.equal(csr_spmm.spmm_csr_dropout(model.feat, x, table[i], 0.3), want)
    with pytest.raises(TypeError, match="int64"):
        csr_spmm.spmm_csr_dropout(model.feat, x, table.to(torch.int32)[0], 0.3)
    assert not np.array_equal(csr_spmm.spmm_csr_dropout(model.feat, x, table[0], 0.3).numpy(),
                              csr_spmm.spmm_csr_dropout(model.feat, x, table[1], 0.3).numpy())
