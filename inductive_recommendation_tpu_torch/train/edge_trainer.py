"""Edge-sharded training from the product surface (counterpart of
``inductive_recommendation_tpu/train/edge_trainer.py``).

``EdgeShardedTrainer`` runs the same epoch / early-stop / checkpoint loop as
every other trainer, with the graph, the embedding table and its Adam
moments sharded over the mesh's 'model' ranks (``parallel/spmm.py``,
``parallel/step.py``), and on a (D, S) mesh the batch split D ways over
'data'. The families (JAX edge_trainer.py:149-191):

- LightGCN: BPR + L2 on the ego rows (``make_edge_sharded_bpr_step``);
- IGCN / IMF: + the auxiliary BPR on the core table, the annealed feature
  weights baked once an epoch, the feature product's dropout drawn from the
  global edge ids (``make_edge_sharded_igcn_step``; IMF is 0 layers);
- every DOSE variant (:data:`DOSE_SUPPORTED`): + the variant's contrastive
  term over shards of the model's per-epoch view CSRs, re-sharded on the
  device after every epoch end (the anneal, then the views' regeneration);
  DOSE_aug2's view branch reads the shard of its per-epoch augmented
  feature matrix; TEST's main adjacency is built from its fixed dropped
  pair set (``make_edge_sharded_dose_step``);
- SGL / HALF: + cross-view / main-vs-view InfoNCE over the drop views'
  shards (``make_edge_sharded_sgl_step``);
- NGCF, IMCGAE (its three shared rows replicated as the parameter
  ``special``), IDCF_LGCN (its frozen table sharded as the feature
  matrix's operand, no gradient, no moments) and AttIGCN (the attention
  softmax sharded, ``parallel/attention.py``).

MF, NeuMF, MultiVAE, ItemKNN and Popularity have no O(|E|) propagation to
shard: they train in data mode. Evaluation scores the step's own forward
over the sharded layouts, gathered to the whole representation on every
rank, through the mesh evaluator (user batches split over every rank;
``recommend`` item-sharded with a k-way merge). Best-model checkpoints hold
the model's own layout (gathered, written by rank 0 behind a barrier), so a
single-device trainer loads them; ``save_state`` / ``load_state`` gather and
re-shard the Adam moments too (IMCGAE's moments stay in its two-parameter
edge layout, so its state resumes in edge mode).

Every rank draws the same global batch and the same dropout seeds as the
single-device trainer of the same seed, and the views are the model's own,
so the losses are that trainer's up to the order of fp32 sums. The DOSE
selection reads the gathered table through the model's own ``get_rep``, as
the single-device trainer's does.
"""

from __future__ import annotations

import numpy as np
import torch

from inductive_recommendation_tpu_torch.data.dataset import AuxiliaryDataset
from inductive_recommendation_tpu_torch.data.sampling import build_sampler_state, sample_bpr_batch
from inductive_recommendation_tpu_torch.eval.evaluator import Evaluator
from inductive_recommendation_tpu_torch.graph import bipartite_edges, build_feat_matrix, sym_normalized_adjacency
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, gather_rows, local_rows
from inductive_recommendation_tpu_torch.parallel.spmm import build_for_mesh, shard_csr
from inductive_recommendation_tpu_torch.parallel.step import (
    make_edge_sharded_att_igcn_step,
    make_edge_sharded_bpr_step,
    make_edge_sharded_dose_step,
    make_edge_sharded_idcf_step,
    make_edge_sharded_igcn_step,
    make_edge_sharded_imcgae_step,
    make_edge_sharded_ngcf_step,
    make_edge_sharded_sgl_step,
)
from inductive_recommendation_tpu_torch.train.trainer import BasicTrainer

#: DOSE variants -> (contrastive mode, the view keys feeding the loss), JAX
#: edge_trainer.py:55-77
DOSE_SUPPORTED = {
    "DOSE_aug": ("single", ("aug_adj",)),
    "DOSE_aug2": ("single", ("aug_adj",)),
    "DOSE_aug3": ("single", ("aug_adj",)),
    "DOSE_aug4": ("single", ("aug_adj",)),
    "DOSE_drop": ("single", ("aug_adj",)),
    "DOSE_drop2": ("single", ("aug_adj",)),
    "DOSE_drop3": ("single", ("aug_adj",)),
    "DOSE_aug_drop2": ("single", ("drop_adj",)),
    "DOSE_aug_drop3": ("single", ("drop_adj",)),
    # both reference terms propagate over the aug view (model.py:3140-3142)
    "DOSE_aug_drop": ("double_same", ("aug_adj",)),
    "TEST2": ("cross", ("aug_adj", "aug_adj2")),
    # TEST's main adjacency is its fixed dropped graph (model.py:1989-1990)
    "TEST": ("single", ("aug_adj",)),
    "DOSE_test": ("mean", ("aug_adj",)),
}

# the families whose loss adds IGCN's auxiliary BPR (a second batch)
_AUX_FAMILIES = ("igcn", "dose", "att_igcn")


def detect_family(model):
    """-> (family, (contrastive mode, view keys) or None): 'bpr' (LightGCN),
    'igcn' (IGCN, IMF), 'dose', 'att_igcn', 'sgl' (SGL, HALF), 'ngcf',
    'imcgae', 'idcf'; raises for the rest (JAX edge_trainer.py:149-191)."""
    from inductive_recommendation_tpu_torch.models import HALF, IDCF_LGCN, IGCN, IMCGAE, NGCF, SGL, AttIGCN, LightGCN
    from inductive_recommendation_tpu_torch.models.dose import _DOSEBase

    name = type(model).__name__
    if isinstance(model, _DOSEBase):
        if name not in DOSE_SUPPORTED:
            raise ValueError(f"{name} has no edge-sharded routing; supported: {sorted(DOSE_SUPPORTED)}")
        return "dose", DOSE_SUPPORTED[name]
    if isinstance(model, AttIGCN):
        return "att_igcn", None
    if isinstance(model, IGCN):
        return "igcn", None
    if isinstance(model, SGL):
        return "sgl", ("single", ("aug_adj1",)) if isinstance(model, HALF) else ("cross", ("aug_adj1", "aug_adj2"))
    if isinstance(model, LightGCN):
        return "bpr", None
    for cls, family in ((NGCF, "ngcf"), (IMCGAE, "imcgae"), (IDCF_LGCN, "idcf")):
        if isinstance(model, cls):
            return family, None
    raise ValueError(
        f"{name} has no edge-sharded step (supported: every full-graph propagation model: LightGCN, SGL/HALF, "
        "NGCF, IMCGAE, IDCF_LGCN, IGCN/IMF/AttIGCN and every DOSE variant); MF, NeuMF, MultiVAE, ItemKNN and "
        "Popularity have no O(|E|) propagation to shard; use mesh_mode='data'"
    )


class _EdgeRepScoring:
    """The model for the evaluator, its scoring state the step's own forward
    over the sharded layouts; everything else is the model's."""

    def __init__(self, model, rep_fn):
        self._model = model
        self._rep = rep_fn

    def make_scoring_state(self, params=None):
        return self._rep()

    def __getattr__(self, name):
        return getattr(self._model, name)


class EdgeShardedTrainer(BasicTrainer):
    """See the module docstring. Config keys beyond BasicTrainer's: ``mesh``
    (required), ``l2_reg``, ``aux_reg`` (IGCN, IMF, DOSE, AttIGCN),
    ``contrastive_reg`` (DOSE, SGL, HALF, IDCF_LGCN)."""

    _data_mesh = False

    def __init__(self, trainer_config, dataset, model):
        cfg = dict(trainer_config)
        if cfg.get("mesh") is None:
            raise ValueError("EdgeShardedTrainer requires a mesh")
        self._family, self._views_spec = detect_family(model)
        super().__init__(cfg, dataset, model)
        n_data = axis_size(self.mesh, "data")
        if self.batch_size % n_data:
            raise ValueError(f"batch_size {self.batch_size} must divide over the 'data' mesh axis (size {n_data})")
        self.l2_reg = cfg["l2_reg"]
        self.aux_reg = cfg.get("aux_reg", 0.0)
        self.contrastive_reg = cfg.get("contrastive_reg", 0.0)
        self._build_layouts(dataset)
        # the dense init weights (the single-device trainer's of this seed),
        # re-laid out: the table padded to the layout's columns, sharded
        self.params = self._local_params({name: p.detach() for name, p in self.params.items()})
        self.initialize_optimizer()
        self._build_step()

    # -- layouts and the step --------------------------------------------------
    def _build_layouts(self, dataset):
        """This rank's shards of the graph (JAX edge_trainer.py:194-462), the
        samplers and, for DOSE and SGL, the views' shards, from ``dataset``."""
        from inductive_recommendation_tpu_torch.models.dose import TEST
        from inductive_recommendation_tpu_torch.models.ngcf import selfloop_l1_coo

        ds, model, mesh, fam = dataset, self.model, self.mesh, self._family
        n = ds.n_users + ds.n_items
        self.sampler = build_sampler_state(ds.train_data, ds.n_items, self.device)
        if fam == "ngcf":
            row, col, val, _ = selfloop_l1_coo(ds)
        else:
            pairs = ds.train_array
            if isinstance(model, TEST):
                self._test_keep = np.asarray(model._main_keep).copy()
                pairs = model._dedup_train[self._test_keep]
            row, col, val = sym_normalized_adjacency(pairs, ds.n_users, ds.n_items)
        self.adj_emat = self.table_emat = build_for_mesh(row, col, val, (n, n), mesh)
        if fam == "idcf":
            row, col = bipartite_edges(ds.train_array, ds.n_users, ds.n_items)
            shape = (n, model.n_old_users + model.n_old_items)
            self.feat_emat = self.table_emat = build_for_mesh(row, col, np.ones(len(row), np.float32), shape, mesh)
            self._frozen = local_rows(model.frozen_embedding, mesh, n_rows=self.feat_emat.n_cols_pad)
        elif fam in _AUX_FAMILIES:
            frow, fcol, counts, row_sum = build_feat_matrix(
                ds.train_array, ds.n_users, ds.n_items, model.user_map, model.item_map
            )
            self.feat_emat = self.table_emat = build_for_mesh(frow, fcol, counts, (n, model.feat_n_cols), mesh)
            self._row_sum = torch.as_tensor(row_sum, device=self.device)
            aux = AuxiliaryDataset(ds, model.user_map, model.item_map)
            self.aux_sampler = build_sampler_state(aux.train_data, aux.n_items, self.device)
        self._refresh_views()

    def _refresh_views(self):
        """This rank's shards of the model's current view CSRs (and of
        DOSE_aug2's augmented feature matrix), cut on the device."""
        self.view_shards = self.aug_shard = None
        if self._views_spec is None:
            return
        self.view_shards = tuple(shard_csr(self.model.views[k], self.mesh, "edge_shard_view")
                                 for k in self._views_spec[1])
        if getattr(self.model, "aug_feat", None) is not None:
            self.aug_shard = shard_csr(self.model.aug_feat, self.mesh, "edge_shard_aug_feat")

    def _build_step(self):
        ds, model, fam = self.dataset, self.model, self._family
        common = (self.mesh, self.optimizer, self.params, self.batch_size, self.l2_reg)
        if fam == "bpr":
            step = make_edge_sharded_bpr_step(self.adj_emat, *common, ds.n_users, model.n_layers)
            run, rep = step, step.eval_rep
        elif fam == "igcn":
            from inductive_recommendation_tpu_torch.models import IMF

            step = make_edge_sharded_igcn_step(
                self.feat_emat, self.adj_emat, self._row_sum, *common, self.aux_reg, ds.n_users, model.user_dim,
                0 if isinstance(model, IMF) else model.n_layers, model.dropout, generator=self.host_generator,
            )
            run = lambda *batch: step(*batch, alpha=self.model.alpha)  # noqa: E731
            rep = lambda: step.eval_rep(self.model.alpha)  # noqa: E731
        elif fam == "dose":
            step = make_edge_sharded_dose_step(
                self.feat_emat, self.adj_emat, self._row_sum, *common, self.aux_reg, self.contrastive_reg,
                ds.n_users, model.user_dim, model.n_layers, model.dropout, contrastive=self._views_spec[0],
                generator=self.host_generator,
            )
            run = lambda *batch: step(  # noqa: E731
                *batch, self.view_shards, alpha=self.model.alpha, aug_feat=self.aug_shard
            )
            rep = lambda: step.eval_rep(self.model.alpha)  # noqa: E731
        elif fam == "att_igcn":
            step = make_edge_sharded_att_igcn_step(
                self.feat_emat, self.adj_emat, self._row_sum, *common, self.aux_reg, ds.n_users, model.user_dim,
                model.n_layers, model.n_heads, model.temperature,
            )
            run, rep = step, step.eval_rep
        elif fam == "sgl":
            step = make_edge_sharded_sgl_step(
                self.adj_emat, *common, self.contrastive_reg, ds.n_users, model.n_layers,
                contrastive=self._views_spec[0],
            )
            run = lambda *batch: step(*batch, self.view_shards)  # noqa: E731
            rep = step.eval_rep
        elif fam == "ngcf":
            step = make_edge_sharded_ngcf_step(
                self.adj_emat, *common, ds.n_users, model.n_layers, model.dropout, generator=self.host_generator
            )
            run, rep = step, step.eval_rep
        elif fam == "imcgae":
            step = make_edge_sharded_imcgae_step(
                self.adj_emat, *common, ds.n_users, model.n_layers, model.dropout, model.operand_width,
                generator=self.host_generator,
            )
            run, rep = step, step.eval_rep
        else:
            step = make_edge_sharded_idcf_step(
                model, self.feat_emat, self.adj_emat, self._frozen, *common, self.contrastive_reg,
                generator=self.host_generator,
            )
            run, rep = step, step.eval_rep
        self._step_fn, self._run = step, run
        self._scoring = _EdgeRepScoring(model, rep)

    def sample(self):
        """The global batch, as the family's single-device trainer draws it:
        (users, pos, neg[, a_users, a_pos, a_neg])."""
        users, pos, neg = sample_bpr_batch(self.sampler, self.generator, self.batch_size)
        if self._family not in _AUX_FAMILIES:
            return users, pos, neg[:, 0]
        a_users, a_pos, a_neg = sample_bpr_batch(self.aux_sampler, self.generator, self.batch_size)
        return users, pos, neg[:, 0], a_users, a_pos, a_neg[:, 0]

    def step(self, *batch):
        return self._run(*(batch or self.sample()))

    # -- parameter layouts -----------------------------------------------------
    def _local_params(self, model_params):
        """The model's parameters -> this rank's leaf tensors: the table's
        rows sharded (IMCGAE: its personal rows, the shared ones apart as
        ``special``), the rest copied."""
        out = {}
        for name, t in model_params.items():
            if self._family == "imcgae" and name == "embedding":
                n = self.dataset.n_users + self.dataset.n_items
                out["embedding"] = self._to_local_layout(name, t[:n])
                out["special"] = t[n : n + 3].to(self.device).clone()
            else:
                out[name] = self._to_local_layout(name, t)
        return {name: t.requires_grad_(True) for name, t in out.items()}

    def _model_params(self):
        params = super()._model_params()
        if self._family == "imcgae":
            params = {"embedding": torch.cat([params["embedding"], params.pop("special")])}
        return params

    @torch.no_grad()
    def _restore_params(self, saved):
        if self._family != "imcgae":
            return super()._restore_params(saved)
        for name, t in self._local_params({"embedding": saved["embedding"]}).items():
            self.params[name].copy_(t)

    def _to_model_layout(self, name, t):
        if name != "embedding":
            return t
        full = gather_rows(t, self.mesh)
        rows = self._shapes[name][0] if self._family != "imcgae" else self.dataset.n_users + self.dataset.n_items
        if full.shape[0] < rows:
            full = torch.cat([full, full.new_zeros(rows - full.shape[0], *full.shape[1:])])
        return full[:rows]

    def _to_local_layout(self, name, t):
        if name != "embedding":
            return t.to(self.device).clone()
        return local_rows(t.to(self.device), self.mesh, n_rows=self.table_emat.n_cols_pad)

    def _rebuild_model_views(self):
        """After a load: the model's views from the restored (gathered)
        params, then their shards; TEST's main adjacency again if the load
        brought another dropped pair set."""
        super()._rebuild_model_views()
        keep = getattr(self, "_test_keep", None)
        if keep is not None and not np.array_equal(keep, self.model._main_keep):
            self._build_layouts(self.dataset)
            self._build_step()
        elif hasattr(self, "adj_emat"):
            self._refresh_views()

    # -- inductive catalog growth (JAX edge_trainer.py:574-612) ----------------
    def attach_dataset(self, dataset):
        """Attach the grown dataset (train plus new interactions) to the model
        and rebuild the sharded layouts, samplers and evaluator around it;
        the trained table and the Adam state stay (the IGCN family's table is
        core-sized, so growth changes only the graph)."""
        if not hasattr(self.model, "attach_dataset"):
            raise ValueError(f"{type(self.model).__name__} has no inductive attach path")
        self.model.attach_dataset(dataset)
        self._rebind_dataset(dataset)

    def _rebind_dataset(self, dataset):
        self.dataset = dataset
        self.steps_per_epoch = max(1, -(-len(dataset) // self.batch_size))
        self.evaluator = Evaluator(
            dataset, self.topks, self.config.get("test_batch_size", 512), device=self.device, mesh=self.mesh
        )
        self._build_layouts(dataset)
        self._build_step()

    def _check_dataset_unchanged(self):
        # a direct model.attach_dataset(...) leaves the sharded layouts stale
        if self.model.dataset is not self.dataset:
            self._rebind_dataset(self.model.dataset)

    # -- the loop and evaluation -----------------------------------------------
    def train_one_epoch(self):
        self._check_dataset_unchanged()
        return super().train_one_epoch()

    def epoch_end(self):
        """The single-device trainer's epoch end: the anneal (IGCN, DOSE,
        AttIGCN), then the views' regeneration (DOSE from the gathered
        params, SGL / HALF drawn anew) and their re-shard."""
        if self._family in _AUX_FAMILIES:
            self.model.feat_mat_anneal()
        if self._family == "dose":
            self.model.update_aug_adj(self._model_params())
        elif self._family == "sgl":
            self.model.update_aug_adj()
        self._refresh_views()

    def eval(self, val_or_test, banned_items=None):
        self._check_dataset_unchanged()
        return self.evaluator.evaluate(self._scoring, None, val_or_test, banned_items=banned_items)

    def inductive_eval(self, n_old_users, n_old_items):
        self._check_dataset_unchanged()
        return self.evaluator.inductive_eval(self._scoring, None, n_old_users, n_old_items, verbose=self.is_writer)

    def recommend(self, stage="test", banned_items=None):
        """Item-sharded retrieval from the edge-sharded representation: the
        single-device trainer's ``recommend`` on the same weights, up to ties."""
        self._check_dataset_unchanged()
        return self.evaluator.recommend(self._scoring, None, stage, banned_items=banned_items)
