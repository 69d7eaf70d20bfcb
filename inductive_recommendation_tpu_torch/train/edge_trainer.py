"""Edge-sharded training from the product surface (counterpart of
``inductive_recommendation_tpu/train/edge_trainer.py``).

``EdgeShardedTrainer`` runs the same epoch / early-stop / checkpoint loop as
every other trainer, with the graph, the embedding table and its Adam
moments sharded over the mesh's 'model' ranks (``parallel/spmm.py``,
``parallel/step.py``), and on a (D, S) mesh the batch split D ways over
'data'. Families of this slice:

- LightGCN: BPR + L2 on the ego rows (``make_edge_sharded_bpr_step``);
- IGCN / IMF: + the auxiliary BPR on the core table, the annealed feature
  weights baked once an epoch, the feature product's dropout drawn from the
  global edge ids (``make_edge_sharded_igcn_step``; IMF is 0 layers).

The other propagation families (the DOSE variants, SGL / HALF, NGCF,
IMCGAE, IDCF_LGCN, AttIGCN) raise: their edge steps come with the next slice
of the port. Evaluation scores the step's own forward over the sharded
layouts, gathered to the whole representation on every rank, through the
mesh evaluator (user batches split over every rank; ``recommend``
item-sharded with a k-way merge). Best-model checkpoints hold the model's
own layout (gathered, written by rank 0 behind a barrier), so a
single-device trainer loads them; ``save_state`` / ``load_state`` gather and
re-shard the Adam moments too.

Every rank draws the same global batch and the same dropout seeds as the
single-device trainer of the same seed, so the losses are that trainer's up
to the order of fp32 sums.
"""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.data.dataset import AuxiliaryDataset
from inductive_recommendation_tpu_torch.data.sampling import build_sampler_state, sample_bpr_batch
from inductive_recommendation_tpu_torch.eval.evaluator import Evaluator
from inductive_recommendation_tpu_torch.graph import build_feat_matrix, sym_normalized_adjacency
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, gather_rows, local_rows
from inductive_recommendation_tpu_torch.parallel.spmm import build_for_mesh
from inductive_recommendation_tpu_torch.parallel.step import make_edge_sharded_bpr_step, make_edge_sharded_igcn_step
from inductive_recommendation_tpu_torch.train.trainer import BasicTrainer, _epoch_mean

NEXT_SLICE = ("DOSE", "SGL", "HALF", "NGCF", "IMCGAE", "IDCF_LGCN", "AttIGCN")


def detect_family(model) -> str:
    """'bpr' (LightGCN) or 'igcn' (IGCN, IMF); raises for the rest (JAX
    edge_trainer.py:149-191)."""
    from inductive_recommendation_tpu_torch.models import AttIGCN, IDCF_LGCN, IGCN, IMCGAE, NGCF, SGL, LightGCN
    from inductive_recommendation_tpu_torch.models.dose import _DOSEBase

    name = type(model).__name__
    if isinstance(model, (_DOSEBase, AttIGCN, SGL, NGCF, IMCGAE, IDCF_LGCN)):
        raise ValueError(
            f"{name} has no edge-sharded step in this slice of the port: it shards LightGCN, IGCN and IMF; "
            f"the edge steps of {', '.join(NEXT_SLICE)} (with AttIGCN's sharded attention) come with the next slice"
        )
    if isinstance(model, IGCN):
        return "igcn"
    if isinstance(model, LightGCN):
        return "bpr"
    raise ValueError(
        f"{name} has no edge-sharded step: MF, NeuMF, MultiVAE, ItemKNN and Popularity have no O(|E|) "
        "propagation to shard; use mesh_mode='data'"
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
    (required), ``l2_reg``, ``aux_reg`` (IGCN / IMF)."""

    _data_mesh = False

    def __init__(self, trainer_config, dataset, model):
        cfg = dict(trainer_config)
        if cfg.get("mesh") is None:
            raise ValueError("EdgeShardedTrainer requires a mesh")
        self._family = detect_family(model)
        super().__init__(cfg, dataset, model)
        n_data = axis_size(self.mesh, "data")
        if self.batch_size % n_data:
            raise ValueError(f"batch_size {self.batch_size} must divide over the 'data' mesh axis (size {n_data})")
        self.l2_reg = cfg["l2_reg"]
        self.aux_reg = cfg.get("aux_reg", 0.0)
        self._build_layouts(dataset)
        # the dense init weights (the single-device trainer's of this seed),
        # re-laid out: the table padded to the layout's columns, sharded
        self.params = {name: self._to_local_layout(name, p.detach()).requires_grad_(True) for name, p in self.params.items()}
        self.initialize_optimizer()
        self._build_step()

    # -- layouts and the step --------------------------------------------------
    def _build_layouts(self, dataset):
        """This rank's shards of the graph (JAX edge_trainer.py:194-462) and
        the samplers, from ``dataset``."""
        ds, model, mesh = dataset, self.model, self.mesh
        n = ds.n_users + ds.n_items
        self.sampler = build_sampler_state(ds.train_data, ds.n_items, self.device)
        row, col, val = sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items)
        self.adj_emat = build_for_mesh(row, col, val, (n, n), mesh)
        if self._family == "bpr":
            self.table_emat = self.adj_emat
            return
        frow, fcol, counts, row_sum = build_feat_matrix(ds.train_array, ds.n_users, ds.n_items, model.user_map, model.item_map)
        self.feat_emat = build_for_mesh(frow, fcol, counts, (n, model.feat_n_cols), mesh)
        self.table_emat = self.feat_emat
        self._row_sum = torch.as_tensor(row_sum, device=self.device)
        aux = AuxiliaryDataset(ds, model.user_map, model.item_map)
        self.aux_sampler = build_sampler_state(aux.train_data, aux.n_items, self.device)

    def _build_step(self):
        ds, model = self.dataset, self.model
        if self._family == "bpr":
            step = make_edge_sharded_bpr_step(
                self.adj_emat, self.mesh, self.optimizer, self.params, self.batch_size, self.l2_reg, ds.n_users,
                model.n_layers,
            )
            self._run = lambda batch: step(*batch)
            rep = step.eval_rep
        else:
            from inductive_recommendation_tpu_torch.models import IMF

            step = make_edge_sharded_igcn_step(
                self.feat_emat, self.adj_emat, self._row_sum, self.mesh, self.optimizer, self.params,
                self.batch_size, self.l2_reg, self.aux_reg, ds.n_users, model.user_dim,
                0 if isinstance(model, IMF) else model.n_layers, model.dropout, generator=self.host_generator,
            )
            self._run = lambda batch: step(*batch, alpha=self.model.alpha)
            rep = lambda: step.eval_rep(self.model.alpha)  # noqa: E731
        self._scoring = _EdgeRepScoring(model, rep)

    def sample(self):
        """The global batch, as the single-device BPRTrainer / IGCNTrainer
        draw it: (users, pos, neg[, a_users, a_pos, a_neg])."""
        users, pos, neg = sample_bpr_batch(self.sampler, self.generator, self.batch_size)
        if self._family == "bpr":
            return users, pos, neg[:, 0]
        a_users, a_pos, a_neg = sample_bpr_batch(self.aux_sampler, self.generator, self.batch_size)
        return users, pos, neg[:, 0], a_users, a_pos, a_neg[:, 0]

    def step(self, *batch):
        return self._run(batch or self.sample())

    # -- parameter layouts -----------------------------------------------------
    def _to_model_layout(self, name, t):
        if name != "embedding":
            return t
        full = gather_rows(t, self.mesh)
        rows = self._shapes[name][0]
        if full.shape[0] < rows:
            full = torch.cat([full, full.new_zeros(rows - full.shape[0], *full.shape[1:])])
        return full[:rows]

    def _to_local_layout(self, name, t):
        if name != "embedding":
            return t.to(self.device).clone()
        return local_rows(t.to(self.device), self.mesh, n_rows=self.table_emat.n_cols_pad)

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
        loss = _epoch_mean([self.step() for _ in range(self.steps_per_epoch)])
        if self._family == "igcn":
            self.model.feat_mat_anneal()
        return loss

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
