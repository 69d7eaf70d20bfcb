"""Training loops (counterpart of ``inductive_recommendation_tpu/train/trainer.py``,
single device, no mesh; reference trainer.py:25-253).

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

Not ported yet: the mesh (the multi-GPU slice).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from inductive_recommendation_tpu_torch.data.dataset import AuxiliaryDataset
from inductive_recommendation_tpu_torch.data.sampling import build_sampler_state, sample_bpr_batch
from inductive_recommendation_tpu_torch.eval.evaluator import Evaluator
from inductive_recommendation_tpu_torch.train.checkpoint import JAX_FORMAT, load_checkpoint, save_checkpoint
from inductive_recommendation_tpu_torch.train.losses import aux_bpr_w, bce_losses, bpr_loss, multinomial_ll_loss

OPTIMIZERS = {"Adam": torch.optim.Adam, "SGD": torch.optim.SGD}


def _epoch_mean(losses) -> float:
    """Mean of an epoch's per-step device losses, in one device-to-host copy."""
    if not losses:
        return 0.0
    return float(torch.stack(losses).double().mean())


class BasicTrainer:
    def __init__(self, trainer_config, dataset, model):
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
        self.evaluator = Evaluator(dataset, self.topks, trainer_config.get("test_batch_size", 512), device=self.device)
        self.params = model.init_params(self.generator)
        self.optimizer = None
        self.steps_per_epoch = max(1, -(-len(dataset) // self.batch_size))

    # -- optimizer (trainer.py:44-46) ---------------------------------------
    def initialize_optimizer(self):
        opt_cls = OPTIMIZERS[self.config["optimizer"]]
        self.optimizer = opt_cls(list(self.params.values()), lr=self.config["lr"])

    # -- one step ------------------------------------------------------------
    def loss(self, *batch) -> torch.Tensor:
        """The loss of one batch, with its autograd graph: a freshly sampled
        one unless the trainer takes its batches as arguments."""
        raise NotImplementedError

    def step(self, *batch) -> torch.Tensor:
        """One optimizer step; returns the batch loss as a device scalar."""
        loss = self.loss(*batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_one_epoch(self) -> float:
        return _epoch_mean([self.step() for _ in range(self.steps_per_epoch)])

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
        missing = sorted(set(self.params) - set(saved))
        if missing:
            raise KeyError(f"the checkpoint lacks parameters {missing}; it has {sorted(saved)}")
        for name, p in self.params.items():
            p.copy_(saved[name])

    def _save_model(self, path):
        save_checkpoint(path, self.params, aux=self.model.checkpoint_aux())

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
            self.model.rebuild_views(self.params)

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
        opt_state = None if self.optimizer is None else self.optimizer.state_dict()
        save_checkpoint(path, self.params, opt_state=opt_state, aux=aux)

    def load_state(self, path):
        payload = load_checkpoint(path)
        if payload.get("format") == JAX_FORMAT:
            raise ValueError(
                f"{path} is a JAX msgpack checkpoint: its optax optimizer state cannot resume a torch optimizer; "
                "load its parameters with _load_model and train on from there"
            )
        self._restore_params(payload["params"])
        if self.optimizer is not None and "opt_state" in payload:
            self.optimizer.load_state_dict(payload["opt_state"])
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
        each validation's metrics."""
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
                if self.save_path and os.path.exists(self.save_path):
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
        return self.evaluator.evaluate(self.model, self.params, val_or_test, banned_items=banned_items)

    def inductive_eval(self, n_old_users, n_old_items):
        return self.evaluator.inductive_eval(self.model, self.params, n_old_users, n_old_items)

    def recommend(self, stage="test", banned_items=None):
        """Top-k_max items for every user -> [n_users, k_max] numpy ('test'
        excludes train+val history, 'val' train, anything else nothing)."""
        return self.evaluator.recommend(self.model, self.params, stage, banned_items=banned_items)


class BPRTrainer(BasicTrainer):
    """BPR + L2 (trainer.py:403-429); MF, LightGCN, NGCF, IMCGAE."""

    def __init__(self, trainer_config, dataset, model):
        super().__init__(trainer_config, dataset, model)
        self.l2_reg = trainer_config["l2_reg"]
        self.initialize_optimizer()
        self.sampler = build_sampler_state(dataset.train_data, dataset.n_items, self.device)

    def loss(self):
        users, pos, neg = sample_bpr_batch(self.sampler, self.generator, self.batch_size)
        out = self.model.bpr_forward(self.params, users, pos, neg[:, 0], training=True, generator=self.host_generator)
        return self._objective(out)

    def _objective(self, out):
        u_r, p_r, n_r, l2 = out[:4]
        return bpr_loss(u_r, p_r, n_r) + self.l2_reg * l2.mean()


class ContrastiveBPRTrainer(BPRTrainer):
    """BPR + L2 + ``contrastive_reg`` times the mean of the fifth,
    contrastive output of the model's ``bpr_forward`` (the loss of the JAX
    package's ``SGLTrainer``, trainer.py:472-511 there); no epoch end
    (``SGLTrainer`` adds one)."""

    def __init__(self, trainer_config, dataset, model):
        super().__init__(trainer_config, dataset, model)
        self.contrastive_reg = trainer_config["contrastive_reg"]

    def _objective(self, out):
        return super()._objective(out) + self.contrastive_reg * out[4].mean()


class SGLTrainer(ContrastiveBPRTrainer):
    """SGL's trainer (JAX trainer.py:472-529): the contrastive BPR loss, and
    at every epoch end the model's drop views regenerated."""

    def train_one_epoch(self):
        loss = super().train_one_epoch()
        self.model.update_aug_adj(self.params)
        return loss


class HALFTrainer(SGLTrainer):
    """The same loss and epoch end (JAX trainer.py:531-532)."""


class IDCFTrainer(ContrastiveBPRTrainer):
    """IDCF_LGCN's trainer (reference trainer.py:488-515): the contrastive BPR
    loss, no view to regenerate at the epoch end."""


class BCETrainer(BasicTrainer):
    """NeuMF's three pretraining phases (reference trainer.py:564-607):
    ``gmf`` for ``mf_pretrain_epochs`` epochs, then ``mlp`` (best checkpoint
    reloaded, optimizer reset), then ``neumf`` (reloaded, optimizer reset, the
    MLP layers re-initialized and the fusion weights set to ones); the loss
    is softplus BCE on one positive and ``neg_ratio`` negatives per user
    (the dataset's ``negative_sample_ratio``) plus L2."""

    def __init__(self, trainer_config, dataset, model):
        super().__init__(trainer_config, dataset, model)
        self.l2_reg = trainer_config["l2_reg"]
        self.mf_pretrain_epochs = trainer_config["mf_pretrain_epochs"]
        self.mlp_pretrain_epochs = trainer_config["mlp_pretrain_epochs"]
        self.neg_ratio = dataset.negative_sample_ratio
        self.initialize_optimizer()
        self.sampler = build_sampler_state(dataset.train_data, dataset.n_items, self.device)

    def loss(self):
        users, pos, neg = sample_bpr_batch(self.sampler, self.generator, self.batch_size, neg_ratio=self.neg_ratio)
        pos_logits, l2_p = self.model.bce_forward(self.params, users, pos)
        neg_logits, l2_n = self.model.bce_forward(self.params, users.repeat_interleave(self.neg_ratio), neg.reshape(-1))
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

    def train_one_epoch(self):
        if self.epoch == self.mf_pretrain_epochs:
            self._switch_arch("mlp")
        if self.epoch == self.mf_pretrain_epochs + self.mlp_pretrain_epochs:
            self._switch_arch("neumf")
            self.model.init_mlp_layers(torch.Generator(device=self.device).manual_seed(self.seed + 7))
        return super().train_one_epoch()


class MLTrainer(BasicTrainer):
    """MultiVAE (reference trainer.py:610-642): shuffled batches of users,
    the multinomial log-likelihood + the annealed KL weight
    min(kl_reg, epoch / n_epochs) times the KL + L2 on the weights.

    An epoch's user order is ``np.random.default_rng((seed, 61, epoch))``'s
    permutation, as in the JAX package; the last batch is padded with user 0
    and a ``valid`` weight of 0. The epoch's loss is the mean over batches
    weighted by their real users."""

    def __init__(self, trainer_config, dataset, model):
        super().__init__(trainer_config, dataset, model)
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

    def loss(self, users, valid):
        """The loss of a batch of ``batches``: its users and valid weights."""
        scores, kl, l2 = self.model.ml_forward(self.params, users, training=True, generator=self.host_generator)
        ml = multinomial_ll_loss(scores, self.model.profiles(users, normalized=False), valid)
        kl_loss = (kl * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        return ml + self.kl_weight() * kl_loss + self.l2_reg * l2.mean()

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

    def __init__(self, trainer_config, dataset, model):
        super().__init__(trainer_config, dataset, model)
        self.l2_reg = trainer_config["l2_reg"]
        self.aux_reg = trainer_config["aux_reg"]
        self.initialize_optimizer()
        self.sampler = build_sampler_state(dataset.train_data, dataset.n_items, self.device)
        aux = AuxiliaryDataset(dataset, model.user_map, model.item_map)
        self.aux_sampler = build_sampler_state(aux.train_data, aux.n_items, self.device)

    def loss(self):
        users, pos, neg = sample_bpr_batch(self.sampler, self.generator, self.batch_size)
        a_users, a_pos, a_neg = sample_bpr_batch(self.aux_sampler, self.generator, self.batch_size)
        out = self.model.bpr_forward(
            self.params, users, pos, neg[:, 0], training=True, generator=self.host_generator
        )
        aux = aux_bpr_w(self.params["embedding"], self.params["w"], a_users, a_pos, a_neg[:, 0], self.model.user_dim)
        return self._objective(out, aux)

    def _objective(self, out, aux):
        u_r, p_r, n_r, l2 = out[:4]
        return bpr_loss(u_r, p_r, n_r) + self.l2_reg * l2.mean() + self.aux_reg * aux

    def train_one_epoch(self):
        loss = super().train_one_epoch()
        self.model.feat_mat_anneal()
        return loss


class DOSEaugTrainer(IGCNTrainer):
    """IGCN's loss + ``contrastive_reg`` times the mean of the model's
    contrastive term (trainer.py:255-306); the epoch ends with the anneal and
    then the views' regeneration from the current params, in that order
    (trainer.py:298-299)."""

    def __init__(self, trainer_config, dataset, model):
        super().__init__(trainer_config, dataset, model)
        self.contrastive_reg = trainer_config["contrastive_reg"]

    def _objective(self, out, aux):
        return super()._objective(out, aux) + self.contrastive_reg * out[4].mean()

    def train_one_epoch(self):
        loss = super().train_one_epoch()
        self.model.update_aug_adj(self.params)
        return loss


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


def get_trainer(trainer_config, dataset, model):
    """Registry factory keyed by config['name'] (trainer.py:16-22). The
    trainer runs on the model's device."""
    return TRAINERS[trainer_config["name"]](trainer_config, dataset, model)
