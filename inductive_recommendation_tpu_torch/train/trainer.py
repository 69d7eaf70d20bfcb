"""Training loops (counterpart of ``inductive_recommendation_tpu/train/trainer.py``;
reference trainer.py:25-253).

- a step draws its batch on the device (``data/sampling.py``), runs the
  model's forward (every sparse product through the hand-written SpMM
  kernel, its backward through the same kernel on the transpose layouts),
  the loss, ``backward`` and the optimizer; nothing of the batch crosses to
  the host;
- an epoch is ceil(len(train pairs) / batch_size) full steps, and its mean
  loss is fetched once at the epoch's end;
- early stopping on NDCG@topks[min(4, len - 1)] with ``max_patience``, and the
  best checkpoint saved, replaced and reloaded at the end, as
  trainer.py:94-112 does;
- randomness: ``self.generator`` on the model's device seeds the initial
  weights and the batches, ``self.host_generator`` (CPU) the dropout masks,
  both from ``config["seed"]`` (default 0).

Adam is ``torch.optim.Adam`` at its defaults (betas 0.9/0.999, eps 1e-8, no
weight decay): the update of ``optax.adam`` at its defaults, up to fp32
rounding. SGD is ``torch.optim.SGD(lr)``, ``optax.sgd``'s plain step.

``train(verbose, writer)`` logs to a duck-typed summary writer (anything with
``add_scalar(tag, value, step)``) with the JAX package's tags
(``{model}_{trainer}/{stage}_{metric}@{k}``, trainer.py:172-182 there). The
train split is evaluated after each epoch only when a writer or the config's
``eval_train_every_epoch`` asks for it, inside the printed epoch time, as the
reference does unconditionally (trainer.py:73).

A JAX msgpack checkpoint loads through ``_load_model`` (params and aux);
its optimizer state does not (``load_state`` raises), since optax's Adam
tree is not ``torch.optim.Adam``'s.

Under a mesh (``get_trainer(..., mesh=make_mesh(...))``, one process per
card, ``parallel/``), every trainer trains data-parallel
(``parallel/step.py``'s data mode: every rank draws the same global batch
and keeps its slice, tables row-sharded over 'model' with their Adam
moments; a contrastive loss gathers the whole batch's view rows as its
negatives; the draws a model makes over the whole batch, MultiVAE's noise,
are made whole on every rank; the epoch ends run alike on every rank from
the same generator state), and evaluation runs the mesh evaluator;
``mesh_mode="edge"`` runs the same trainer with the graph, the embedding
table and its Adam moments sharded over 'model' and the batch split over
'data': its model's forward passes run under the edge placement
(``parallel/placement.py``), its own ``sample``, ``batch_loss`` and
``epoch_end`` serve, and its step is ``parallel/step.py::make_edge_step``.
Every rank draws the same batches and dropout seeds as the single-device
trainer of the same seed, so the losses are that trainer's up to the order
of fp32 sums (at world 1, bit for bit). Edge mode takes the models that
declare a graph propagation (``graph_propagation``; the JAX package's
edge_trainer.py:149-191). Checkpoints hold the model's own layout, written
by rank 0 behind a barrier, so a single-device trainer loads them (a model
that keeps rows of its table apart in edge mode, IMCGAE's ``special``,
keeps its Adam moments in that layout, so its state resumes in edge mode).

A direct ``model.attach_dataset(grown)`` is followed too: before an epoch,
an evaluation or a recommendation the trainer rebinds its samplers and its
evaluator to the dataset its model holds, as ``attach_dataset`` does.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from inductive_recommendation_tpu_torch.data.dataset import AuxiliaryDataset
from inductive_recommendation_tpu_torch.data.sampling import build_sampler_state, sample_bpr_batch
from inductive_recommendation_tpu_torch.eval.evaluator import Evaluator
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, gather_rows, local_rows, param_spec, shard_params
from inductive_recommendation_tpu_torch.parallel.placement import EdgePlacement
from inductive_recommendation_tpu_torch.parallel.step import (
    gather_negatives,
    make_data_step,
    make_edge_step,
    mean_loss_on_slice,
)
from inductive_recommendation_tpu_torch.train.checkpoint import JAX_FORMAT, load_checkpoint, save_checkpoint
from inductive_recommendation_tpu_torch.train.losses import aux_bpr_rows, bce_losses, bpr_loss, multinomial_ll_loss
from inductive_recommendation_tpu_torch.utils.profiling import span

OPTIMIZERS = {"Adam": torch.optim.Adam, "SGD": torch.optim.SGD}


def _epoch_mean(losses) -> float:
    """Mean of an epoch's per-step device losses, in one device-to-host copy."""
    if not losses:
        return 0.0
    return float(torch.stack(losses).double().mean())


class BasicTrainer:
    """``mesh_mode`` (under a mesh): 'data', the model whole on every rank
    and its tables row-sharded; 'edge', the graph sharded too, the model's
    forward passes under ``self.placement``."""

    def __init__(self, trainer_config, dataset, model, mesh_mode="data"):
        self.config = dict(trainer_config)
        self.name = trainer_config["name"]
        self.dataset = dataset
        self.model = model
        self.topks = trainer_config["topks"]
        self.n_epochs = trainer_config["n_epochs"]
        self.max_patience = trainer_config.get("max_patience", 50)
        self.val_interval = trainer_config.get("val_interval", 1)
        # the reference evaluates the train split every epoch (trainer.py:73);
        # here only when this is set or a writer consumes it
        self.eval_train_every_epoch = bool(trainer_config.get("eval_train_every_epoch", False))
        self.batch_size = trainer_config.get("batch_size", 2048)
        self.epoch = 0
        self.best_ndcg = -np.inf
        # remaining early-stop budget; persisted by save_state so that a
        # resumed run stops where the uninterrupted one would
        self.patience = self.max_patience
        self.save_path = None
        self.seed = int(trainer_config.get("seed", 0))
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.host_generator = torch.Generator().manual_seed(self.seed)
        # optional ('data', 'model') DeviceMesh (get_trainer's mesh=); None:
        # one device
        self.mesh = self.config.get("mesh")
        # edge mode's placement of the model's forward passes; None: the
        # model's own (one device, or whole on every rank in data mode)
        self.placement = None
        if self.mesh is not None and mesh_mode == "edge":
            if not model.graph_propagation:
                raise ValueError(
                    f"{type(model).__name__} has no O(|E|) graph propagation to shard (edge mode takes LightGCN, "
                    "SGL/HALF, NGCF, IMCGAE, IDCF_LGCN, IGCN/IMF/AttIGCN and every DOSE variant); use mesh_mode='data'"
                )
            self.placement = EdgePlacement(self.mesh)
        # the dataset the model held when last bound: a direct
        # model.attach_dataset(...) replaces it (_follow_model_dataset)
        self._model_dataset = model.dataset
        self.evaluator = Evaluator(
            dataset, self.topks, trainer_config.get("test_batch_size", 512), device=self.device, mesh=self.mesh
        )
        self.params = model.init_params(self.generator)
        if self.placement is not None:
            self.params = model.edge_params(self.params)
        # the parameter shapes before sharding: checkpoints hold this layout
        self._shapes = {name: tuple(p.shape) for name, p in self.params.items()}
        self._mesh_step = None
        if self.mesh is not None:
            # data mode slices the batch over every rank, edge mode over 'data'
            n, what = (self.mesh.size(), "the mesh") if self.placement is None else (
                axis_size(self.mesh, "data"), "the mesh's 'data' axis")
            if self.batch_size % n:
                raise ValueError(f"batch_size {self.batch_size} must divide over {what} ({n} ranks)")
            self.params = shard_params(self.params, self.mesh)
        self.optimizer = None
        self.steps_per_epoch = max(1, -(-len(dataset) // self.batch_size))

    def _placed(self):
        """The block in which the model's forward passes run under this
        trainer's placement (edge mode)."""
        return contextlib.nullcontext() if self.placement is None else self.model.placed(self.placement)

    def _scoring_params(self):
        """The parameters evaluation scores with: this rank's in edge mode
        (the model's forward gathers its representation), else the model's
        layout."""
        return self.params if self.placement is not None else self._model_params()

    @property
    def is_writer(self) -> bool:
        """The rank that writes files and prints: rank 0 under a mesh."""
        return self.mesh is None or dist.get_rank() == 0

    # -- parameter layouts ---------------------------------------------------
    def _to_model_layout(self, name, t):
        """A parameter (or a tensor of its shape) of this rank -> the model's
        own layout, the same on every rank."""
        if self.mesh is None or not param_spec(name, t):
            return t
        return gather_rows(t, self.mesh)[: self._shapes[name][0]]

    def _to_local_layout(self, name, t):
        """The model's layout -> this rank's part."""
        if self.mesh is None or not param_spec(name, t):
            return t
        return local_rows(t.to(self.device), self.mesh)

    def _model_params(self):
        """The parameters in the model's own layout (gathered under a mesh)."""
        params = {name: self._to_model_layout(name, p) for name, p in self.params.items()}
        return params if self.placement is None else self.model.from_edge_params(params)

    def _map_opt_state(self, state, convert):
        """``optimizer.state_dict()`` with ``convert(name, t)`` applied to the
        per-parameter tensors shaped like their parameter."""
        names = list(self.params)
        out = dict(state, state={})
        for idx, entry in state["state"].items():
            name = names[idx]
            out["state"][idx] = {
                k: convert(name, v) if isinstance(v, torch.Tensor) and v.ndim == 2 else v for k, v in entry.items()
            }
        return out

    # -- optimizer (trainer.py:44-46) ---------------------------------------
    def initialize_optimizer(self):
        opt_cls = OPTIMIZERS[self.config["optimizer"]]
        self.optimizer = opt_cls(list(self.params.values()), lr=self.config["lr"])

    # -- one step ------------------------------------------------------------
    def sample(self):
        """The step's global batch, a tuple of tensors."""
        raise NotImplementedError

    def batch_loss(self, params, *batch, negatives=None) -> torch.Tensor:
        """The mean-based objective of ``batch`` (or of a data-mode slice of
        it) with ``params``; ``negatives`` maps a slice's view rows to the
        whole batch's (contrastive losses)."""
        raise NotImplementedError

    def _local_loss(self):
        """Under a mesh: this rank's term of the global loss (the steps of
        ``parallel/step.py``), in edge mode under the placement."""
        if self.placement is None:
            return mean_loss_on_slice(lambda full, *b: self.batch_loss(full, *b, negatives=gather_negatives),
                                      self.batch_size)

        def placed_loss(params, *b):
            with self._placed():
                return self.batch_loss(params, *b, negatives=self.placement.negatives)

        return mean_loss_on_slice(placed_loss, self.batch_size)

    def step(self, *batch) -> torch.Tensor:
        """One optimizer step on ``batch`` (a freshly sampled one unless
        given); returns the batch loss as a device scalar. On one device its
        four phases are the spans ``irt.train.sample``, ``forward``,
        ``backward`` and ``optimizer`` inside ``irt.train.step``."""
        if self.mesh is not None:
            if self._mesh_step is None:
                if self.placement is None:
                    self._mesh_step = make_data_step(lambda: self.optimizer, self.params, self.batch_size, self.mesh,
                                                     self._local_loss(), prepare=self._prepare_batch)
                else:
                    self._mesh_step = make_edge_step(lambda: self.optimizer, self.params, self.batch_size, self.mesh,
                                                     self._local_loss())
            return self._mesh_step(*(batch or self.sample()))
        with span("irt.train.step"):
            with span("irt.train.sample"):
                batch = batch or self.sample()
            with span("irt.train.forward"):
                loss = self.batch_loss(self.params, *batch)
            with span("irt.train.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with span("irt.train.optimizer"):
                self.optimizer.step()
            return loss.detach()

    _prepare_batch = None

    def train_one_epoch(self) -> float:
        self._follow_model_dataset()
        losses = [self.step() for _ in range(self.steps_per_epoch)]
        with span("irt.train.epoch_end"):
            loss = _epoch_mean(losses)
            self.epoch_end()
        return loss

    def epoch_end(self):
        """The model's work at the end of an epoch, after the epoch's loss is
        fetched: none here."""

    # -- logging (trainer.py:51-56) -----------------------------------------
    def record(self, writer, stage, metrics, epoch=None):
        epoch = self.epoch if epoch is None else epoch
        for metric in metrics:
            for k in self.topks:
                writer.add_scalar(
                    "{:s}_{:s}/{:s}_{:s}@{:d}".format(self.model.name, self.name, stage, metric, k),
                    metrics[metric][k],
                    epoch,
                )

    # -- checkpoint helpers --------------------------------------------------
    @torch.no_grad()
    def _restore_params(self, saved):
        if self.placement is not None:
            saved = self.model.edge_params(saved)
        missing = sorted(set(self.params) - set(saved))
        if missing:
            raise KeyError(f"the checkpoint lacks parameters {missing}; it has {sorted(saved)}")
        for name, p in self.params.items():
            p.copy_(self._to_local_layout(name, saved[name]))

    def _write(self, path, params, opt_state=None, aux=None):
        """Rank 0 writes; under a mesh every rank waits for the file."""
        if self.is_writer:
            save_checkpoint(path, params, opt_state=opt_state, aux=aux)
        if self.mesh is not None:
            dist.barrier()

    def _save_model(self, path):
        self._write(path, self._model_params(), aux=self.model.checkpoint_aux())

    def _load_model(self, path):
        payload = load_checkpoint(path)
        self._restore_params(payload["params"])
        self.model.restore_aux(payload.get("aux", {}))
        self._rebuild_model_views()

    def _rebuild_model_views(self):
        """DOSE models regenerate their views from the restored params and
        counters (trainer.py:188-199 of the JAX package); other models have
        no such hook."""
        if hasattr(self.model, "rebuild_views"):
            self.model.rebuild_views(self._model_params())

    # -- full training-state resume -----------------------------------------
    def save_state(self, path):
        aux = dict(self.model.checkpoint_aux())
        aux["__trainer__"] = {
            "epoch": self.epoch,
            "best_ndcg": float(self.best_ndcg),
            "save_path": self.save_path or "",
            "patience": int(self.patience),
            "generator": self.generator.get_state(),
            "host_generator": self.host_generator.get_state(),
        }
        opt_state = None
        if self.optimizer is not None:
            opt_state = self._map_opt_state(self.optimizer.state_dict(), self._to_model_layout)
        self._write(path, self._model_params(), opt_state=opt_state, aux=aux)

    def load_state(self, path):
        payload = load_checkpoint(path)
        if payload.get("format") == JAX_FORMAT:
            raise ValueError(
                f"{path} is a JAX msgpack checkpoint: its optax optimizer state cannot resume a torch optimizer; "
                "load its parameters with _load_model and train on from there"
            )
        self._restore_params(payload["params"])
        if self.optimizer is not None and "opt_state" in payload:
            self.optimizer.load_state_dict(self._map_opt_state(payload["opt_state"], self._to_local_layout))
        aux = dict(payload.get("aux", {}))
        ts = aux.pop("__trainer__", {})
        self.model.restore_aux(aux)
        self._rebuild_model_views()
        self.epoch = int(ts.get("epoch", 0))
        self.best_ndcg = float(ts.get("best_ndcg", -np.inf))
        self.save_path = ts.get("save_path") or None
        self.patience = int(ts.get("patience", self.max_patience))
        if "generator" in ts:
            self.generator.set_state(ts["generator"])
            self.host_generator.set_state(ts["host_generator"])

    # -- main loop (trainer.py:58-113) --------------------------------------
    def train(self, verbose=True, writer=None):
        """Trains up to ``n_epochs`` (from ``self.epoch``, so a restored state
        resumes), validates every ``val_interval`` epochs, keeps the best
        checkpoint under ``checkpoints/`` in the working directory and
        reloads it at the end. Returns the best validation NDCG. A model
        that does not train (ItemKNN, Popularity) is validated once and its
        NDCG@topks[min(5, len - 1)] returned (trainer.py:64 of the
        reference). ``writer`` gets each epoch's loss and train metrics and
        each validation's metrics. Under a mesh every rank runs the loop
        (the metrics agree on every rank, so do the decisions) and rank 0
        prints, writes and removes the files."""
        verbose, writer = (verbose, writer) if self.is_writer else (False, None)
        if not self.model.trainable:
            results, metrics = self.eval("val")
            if verbose:
                print("Validation result. {:s}".format(results))
            return metrics["NDCG"][self.topks[min(5, len(self.topks) - 1)]]
        os.makedirs("checkpoints", exist_ok=True)
        for epoch in range(self.epoch, self.n_epochs):
            # self.epoch counts completed epochs; during one it is its index
            self.epoch = epoch
            start_time = time.time()
            loss = self.train_one_epoch()
            self.epoch = epoch + 1
            if writer or self.eval_train_every_epoch:
                _, train_metrics = self.eval("train")
            if writer:
                writer.add_scalar("{:s}_{:s}/train_loss".format(self.model.name, self.name), loss, epoch)
                self.record(writer, "train", train_metrics, epoch=epoch)
            if verbose:
                print(
                    "Epoch {:d}/{:d}, Loss: {:.6f}, Time: {:.3f}s".format(
                        epoch, self.n_epochs, loss, time.time() - start_time
                    )
                )
            if (epoch + 1) % self.val_interval != 0:
                continue

            start_time = time.time()
            results, metrics = self.eval("val")
            if verbose:
                print("Validation result. {:s}Time: {:.3f}s".format(results, time.time() - start_time))
            if writer:
                self.record(writer, "validation", metrics, epoch=epoch)
            ndcg = metrics["NDCG"][self.topks[min(4, len(self.topks) - 1)]]
            if ndcg > self.best_ndcg:
                if self.is_writer and self.save_path and os.path.exists(self.save_path):
                    os.remove(self.save_path)
                self.save_path = os.path.join(
                    "checkpoints",
                    "{:s}_{:s}_{:s}_{:.3f}.ckpt".format(self.model.name, self.name, self.dataset.name, ndcg * 100),
                )
                self.best_ndcg = ndcg
                self._save_model(self.save_path)
                self.patience = self.max_patience
                if verbose:
                    print("Best NDCG, save model to {:s}".format(self.save_path))
            else:
                self.patience -= self.val_interval
                if self.patience <= 0:
                    if verbose:
                        print("Early stopping!")
                    break

        # a restored save_path may point at a deleted file
        if self.save_path and os.path.exists(self.save_path):
            self._load_model(self.save_path)
        return self.best_ndcg

    # -- evaluation (delegates; trainer.py:146-210) -------------------------
    def eval(self, val_or_test, banned_items=None):
        self._follow_model_dataset()
        with self._placed():
            return self.evaluator.evaluate(self.model, self._scoring_params(), val_or_test, banned_items=banned_items)

    def inductive_eval(self, n_old_users, n_old_items):
        self._follow_model_dataset()
        with self._placed():
            return self.evaluator.inductive_eval(
                self.model, self._scoring_params(), n_old_users, n_old_items, verbose=self.is_writer
            )

    def recommend(self, stage="test", banned_items=None):
        """Top-k_max items for every user -> [n_users, k_max] numpy ('test'
        excludes train+val history, 'val' train, anything else nothing)."""
        self._follow_model_dataset()
        with self._placed():
            return self.evaluator.recommend(self.model, self._scoring_params(), stage, banned_items=banned_items)

    # -- inductive catalog growth (JAX edge_trainer.py:574-612) ----------------
    def attach_dataset(self, dataset):
        """Attach the grown dataset (train plus new interactions) to the model
        and rebuild the samplers and the evaluator around it; the trained
        weights and the optimizer's state stay (an inductive model's table
        is core-sized, so growth changes only the graph)."""
        if not hasattr(self.model, "attach_dataset"):
            raise ValueError(f"{type(self.model).__name__} has no inductive attach path")
        self.model.attach_dataset(dataset)
        self._rebind_dataset(dataset)

    def _follow_model_dataset(self):
        """Rebind to the model's dataset after a direct
        ``model.attach_dataset(grown)`` (the single-device habit), which
        would otherwise leave the samplers and the evaluator on the old one."""
        if self.model.dataset is not self._model_dataset:
            self._rebind_dataset(self.model.dataset)

    def _rebind_dataset(self, dataset):
        self._model_dataset = self.dataset = dataset
        self.steps_per_epoch = max(1, -(-len(dataset) // self.batch_size))
        self.evaluator = Evaluator(
            dataset, self.topks, self.config.get("test_batch_size", 512), device=self.device, mesh=self.mesh
        )
        self._build_samplers(dataset)

    def _build_samplers(self, dataset):
        """The samplers of ``dataset``'s batches: none here."""


class BPRTrainer(BasicTrainer):
    """BPR + L2 (trainer.py:403-429); MF, LightGCN, NGCF, IMCGAE."""

    def __init__(self, trainer_config, dataset, model, **mesh_mode):
        super().__init__(trainer_config, dataset, model, **mesh_mode)
        self.l2_reg = trainer_config["l2_reg"]
        self.initialize_optimizer()
        self._build_samplers(dataset)

    def _build_samplers(self, dataset):
        self.sampler = build_sampler_state(dataset.train_data, dataset.n_items, self.device)

    def sample(self):
        """The step's batch: (users, pos, neg) of the global batch."""
        users, pos, neg = sample_bpr_batch(self.sampler, self.generator, self.batch_size)
        return users, pos, neg[:, 0]

    def batch_loss(self, params, users, pos, neg, negatives=None):
        out = self.model.bpr_forward(params, users, pos, neg, training=True, generator=self.host_generator)
        return self._objective(out)

    def _objective(self, out):
        u_r, p_r, n_r, l2 = out[:4]
        return bpr_loss(u_r, p_r, n_r) + self.l2_reg * l2.mean()


class ContrastiveBPRTrainer(BPRTrainer):
    """BPR + L2 + ``contrastive_reg`` times the mean of the fifth,
    contrastive output of the model's ``bpr_forward`` (the loss of the JAX
    package's ``SGLTrainer``, trainer.py:472-511 there); no epoch end
    (``SGLTrainer`` adds one)."""

    def __init__(self, trainer_config, dataset, model, **mesh_mode):
        super().__init__(trainer_config, dataset, model, **mesh_mode)
        self.contrastive_reg = trainer_config["contrastive_reg"]

    def _objective(self, out):
        return super()._objective(out) + self.contrastive_reg * out[4].mean()


class SGLTrainer(ContrastiveBPRTrainer):
    """SGL's trainer (JAX trainer.py:472-529): the contrastive BPR loss, and
    at every epoch end the model's drop views regenerated. The InfoNCE
    takes its negatives from the batch's view rows (``negatives``: a
    data-mode slice's rows -> the whole batch's)."""

    def batch_loss(self, params, users, pos, neg, negatives=None):
        out = self.model.bpr_forward(params, users, pos, neg, training=True, generator=self.host_generator,
                                     negatives=negatives)
        return self._objective(out)

    def epoch_end(self):
        self.model.update_aug_adj()


class HALFTrainer(SGLTrainer):
    """The same loss and epoch end (JAX trainer.py:531-532)."""


class IDCFTrainer(ContrastiveBPRTrainer):
    """IDCF_LGCN's trainer (reference trainer.py:488-515): the contrastive BPR
    loss, no view to regenerate at the epoch end. Its contrastive term is
    per node, so a data-mode slice needs no other rows."""


class BCETrainer(BasicTrainer):
    """NeuMF's three pretraining phases (reference trainer.py:564-607):
    ``gmf`` for ``mf_pretrain_epochs`` epochs, then ``mlp`` (best checkpoint
    reloaded, optimizer reset), then ``neumf`` (reloaded, optimizer reset, the
    MLP layers re-initialized and the fusion weights set to ones); the loss
    is softplus BCE on one positive and ``neg_ratio`` negatives per user
    (the dataset's ``negative_sample_ratio``) plus L2."""

    def __init__(self, trainer_config, dataset, model, **mesh_mode):
        super().__init__(trainer_config, dataset, model, **mesh_mode)
        self.l2_reg = trainer_config["l2_reg"]
        self.mf_pretrain_epochs = trainer_config["mf_pretrain_epochs"]
        self.mlp_pretrain_epochs = trainer_config["mlp_pretrain_epochs"]
        self.neg_ratio = dataset.negative_sample_ratio
        self.initialize_optimizer()
        self.sampler = build_sampler_state(dataset.train_data, dataset.n_items, self.device)

    def sample(self):
        """(users [B], pos [B], neg [B, neg_ratio])."""
        return sample_bpr_batch(self.sampler, self.generator, self.batch_size, neg_ratio=self.neg_ratio)

    def batch_loss(self, params, users, pos, neg, negatives=None):
        pos_logits, l2_p = self.model.bce_forward(params, users, pos)
        neg_logits, l2_n = self.model.bce_forward(params, users.repeat_interleave(self.neg_ratio), neg.reshape(-1))
        return bce_losses(pos_logits, neg_logits).mean() + self.l2_reg * torch.cat([l2_p, l2_n]).mean()

    def _switch_arch(self, arch):
        """Reload the phase's best checkpoint, then switch: the checkpoint
        restores the arch it was saved in, which would undo a switch made
        first (JAX trainer.py:676-691)."""
        if self.save_path and os.path.exists(self.save_path):
            self._load_model(self.save_path)
        self.model.arch = arch
        self.initialize_optimizer()
        self.best_ndcg = -np.inf

    @torch.no_grad()
    def _init_mlp_layers(self):
        """The model re-initializes its MLP layers and fusion weights in
        place; a data-mode trainer's parameters are its own tensors, so the
        fresh values are copied into them."""
        fresh = self.model.init_mlp_layers(torch.Generator(device=self.device).manual_seed(self.seed + 7))
        for name, t in fresh.items():
            if (name.startswith("mlp_layers.") or name == "output_w") and self.params[name] is not t:
                self.params[name].copy_(self._to_local_layout(name, t))

    def train_one_epoch(self):
        if self.epoch == self.mf_pretrain_epochs:
            self._switch_arch("mlp")
        if self.epoch == self.mf_pretrain_epochs + self.mlp_pretrain_epochs:
            self._switch_arch("neumf")
            self._init_mlp_layers()
        return super().train_one_epoch()


class MLTrainer(BasicTrainer):
    """MultiVAE (reference trainer.py:610-642): shuffled batches of users,
    the multinomial log-likelihood + the annealed KL weight
    min(kl_reg, epoch / n_epochs) times the KL + L2 on the weights.

    An epoch's user order is ``np.random.default_rng((seed, 61, epoch))``'s
    permutation, as in the JAX package; the last batch is padded with user 0
    and a ``valid`` weight of 0. The epoch's loss is the mean over batches
    weighted by their real users. In data mode the batch's noise is drawn
    whole on every rank (``MultiVAE.draw_noise``) and a slice's terms are
    normalized by the whole batch's real users."""

    def __init__(self, trainer_config, dataset, model, **mesh_mode):
        super().__init__(trainer_config, dataset, model, **mesh_mode)
        self.l2_reg = trainer_config["l2_reg"]
        self.kl_reg = trainer_config["kl_reg"]
        self.initialize_optimizer()
        self.steps_per_epoch = max(1, -(-dataset.n_users // self.batch_size))

    def batches(self, epoch):
        """[(users [B] int64, valid [B] fp32, real users)] of ``epoch``, on
        the model's device: the padded order goes to the device in one copy."""
        perm = np.random.default_rng((self.seed, 61, epoch)).permutation(self.dataset.n_users)
        B, n_users = self.batch_size, len(perm)
        pad = self.steps_per_epoch * B - n_users
        users = torch.as_tensor(np.concatenate([perm, np.zeros(pad, perm.dtype)]), device=self.device).view(-1, B)
        valid = (torch.arange(users.numel(), device=self.device) < n_users).to(torch.float32).view(-1, B)
        return [(users[i], valid[i], min(B, n_users - i * B)) for i in range(self.steps_per_epoch)]

    def kl_weight(self) -> float:
        return min(self.kl_reg, 1.0 * self.epoch / max(self.n_epochs, 1))

    def batch_loss(self, params, users, valid, negatives=None, keep=None, eps=None, n_valid=None, share=1.0):
        """The loss of a batch of ``batches``: its users and valid weights;
        a data-mode slice passes its rows of the whole batch's noise, the
        whole batch's real users ``n_valid`` and its ``share`` of the batch."""
        noise = {k: t for k, t in (("keep", keep), ("eps", eps)) if t is not None}
        scores, kl, l2 = self.model.ml_forward(params, users, training=True, generator=self.host_generator, **noise)
        n_valid = valid.sum() if n_valid is None else n_valid
        ml = multinomial_ll_loss(scores, self.model.profiles(users, normalized=False), valid, n_valid)
        kl_loss = (kl * valid).sum() / torch.clamp(n_valid, min=1.0)
        return ml + self.kl_weight() * kl_loss + share * self.l2_reg * l2.mean()

    def _prepare_batch(self, users, valid):
        return (users, valid, *self.model.draw_noise(len(users), self.host_generator))

    def _local_loss(self):
        def local_loss(full, sl, users, valid, keep, eps):
            return self.batch_loss(full, users[sl], valid[sl], keep=None if keep is None else keep[sl], eps=eps[sl],
                                   n_valid=valid.sum(), share=(sl.stop - sl.start) / self.batch_size)

        return local_loss

    def train_one_epoch(self):
        losses, weights = [], []
        for users, valid, n in self.batches(self.epoch):
            losses.append(self.step(users, valid))
            weights.append(n)
        return float(np.average(torch.stack(losses).double().cpu().numpy(), weights=weights))


class IGCNTrainer(BasicTrainer):
    """BPR + L2 + the auxiliary BPR on the raw core embeddings weighted by the
    model's per-dimension ``w`` (trainer.py:518-561); anneals the feature
    matrix at the end of every epoch, before validation (trainer.py:559).
    A model whose ``bpr_forward`` returns a fifth, contrastive term (the
    reference pairs DOSE_drop2 with this trainer, config.py:146-151) trains
    without it, as in the JAX package."""

    def __init__(self, trainer_config, dataset, model, **mesh_mode):
        super().__init__(trainer_config, dataset, model, **mesh_mode)
        self.l2_reg = trainer_config["l2_reg"]
        self.aux_reg = trainer_config["aux_reg"]
        self.initialize_optimizer()
        self._build_samplers(dataset)

    def _build_samplers(self, dataset):
        self.sampler = build_sampler_state(dataset.train_data, dataset.n_items, self.device)
        aux = AuxiliaryDataset(dataset, self.model.user_map, self.model.item_map)
        self.aux_sampler = build_sampler_state(aux.train_data, aux.n_items, self.device)

    def sample(self):
        """The step's batches: (users, pos, neg, a_users, a_pos, a_neg), the
        main batch then the auxiliary one over the core ids."""
        users, pos, neg = sample_bpr_batch(self.sampler, self.generator, self.batch_size)
        a_users, a_pos, a_neg = sample_bpr_batch(self.aux_sampler, self.generator, self.batch_size)
        return users, pos, neg[:, 0], a_users, a_pos, a_neg[:, 0]

    def batch_loss(self, params, users, pos, neg, a_users, a_pos, a_neg, negatives=None):
        out = self.model.bpr_forward(params, users, pos, neg, training=True, generator=self.host_generator)
        return self._objective(out, self._aux(params, a_users, a_pos, a_neg))

    def _aux(self, params, a_users, a_pos, a_neg):
        """The auxiliary BPR on the core table's rows of the aux batch."""
        rows = self.model.placement.batch_rows(params["embedding"], a_users, a_pos, a_neg, self.model.user_dim)
        return aux_bpr_rows(*rows, params["w"])

    def _objective(self, out, aux):
        u_r, p_r, n_r, l2 = out[:4]
        return bpr_loss(u_r, p_r, n_r) + self.l2_reg * l2.mean() + self.aux_reg * aux

    def epoch_end(self):
        self.model.feat_mat_anneal()


class DOSEaugTrainer(IGCNTrainer):
    """IGCN's loss + ``contrastive_reg`` times the mean of the model's
    contrastive term (trainer.py:255-306); the epoch ends with the anneal and
    then the views' regeneration from the current params, in that order
    (trainer.py:298-299). The InfoNCE takes its negatives from the batch's
    view rows, as ``SGLTrainer``'s."""

    def __init__(self, trainer_config, dataset, model, **mesh_mode):
        super().__init__(trainer_config, dataset, model, **mesh_mode)
        self.contrastive_reg = trainer_config["contrastive_reg"]

    def batch_loss(self, params, users, pos, neg, a_users, a_pos, a_neg, negatives=None):
        out = self.model.bpr_forward(params, users, pos, neg, training=True, generator=self.host_generator,
                                     negatives=negatives)
        return self._objective(out, self._aux(params, a_users, a_pos, a_neg))

    def _objective(self, out, aux):
        return super()._objective(out, aux) + self.contrastive_reg * out[4].mean()

    def epoch_end(self):
        super().epoch_end()
        self.model.update_aug_adj(self._model_params())


class DOSEdropTrainer(DOSEaugTrainer):
    """The same loss and epoch end (trainer.py:307-353)."""


class DOSEtestTrainer(DOSEaugTrainer):
    """The same loss and epoch end (trainer.py:355-402); its DOSE_test model
    returns the view's user reps in the contrastive slot."""


TRAINERS = {
    cls.__name__: cls
    for cls in (
        BasicTrainer, BPRTrainer, IGCNTrainer, IDCFTrainer, BCETrainer, MLTrainer, SGLTrainer, HALFTrainer,
        DOSEaugTrainer, DOSEdropTrainer, DOSEtestTrainer,
    )
}


def get_trainer(trainer_config, dataset, model, mesh=None, mesh_mode="data"):
    """Registry factory keyed by config['name'] (trainer.py:16-22 and JAX
    trainer.py:792-814). The trainer runs on the model's device.

    ``mesh``: a ('data', 'model') ``DeviceMesh`` (``parallel.make_mesh``) over
    the ranks of a torchrun launch. ``mesh_mode="data"``: the named trainer
    trains data-parallel with row-sharded tables. ``mesh_mode="edge"``: the
    named trainer with the graph, the table and its Adam moments sharded
    over 'model' (the edge placement)."""
    if mesh_mode not in ("data", "edge"):
        raise ValueError(f"mesh_mode {mesh_mode!r} is not 'data' or 'edge'")
    if mesh is None:
        return TRAINERS[trainer_config["name"]](trainer_config, dataset, model)
    return TRAINERS[trainer_config["name"]](dict(trainer_config, mesh=mesh), dataset, model, mesh_mode=mesh_mode)
