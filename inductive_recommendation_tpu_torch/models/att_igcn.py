"""AttIGCN: IGCN with attention-weighted feature aggregation (counterpart of
``inductive_recommendation_tpu/models/att_igcn.py``; the reference ships the
class commented out, model.py:4224-4287, and the JAX package treats that code
as the spec):

- q = Wq(feat @ sg(emb)), k = Wk(sg(emb)), ``n_heads`` heads (model.py:4258-4264);
- per-edge scores q[row] . k[col], an edge softmax per row at temperature
  sqrt(d) * 10, averaged over the heads (model.py:4270-4275);
- the aggregation weights the NON-detached embedding by the attention
  (model.py:4279);
- feature_ratio is 1 and alpha 0 (model.py:4231-4232): the query's feature
  weights are row_sum^-1, and they stay so through ``feat_mat_anneal``;
- the L2 term adds ||Wq||^2 + ||Wk||^2 (model.py:4283-4286).

The query product is the hand-written SpMM on ``feat`` (no dropout: the
spec's rep layer takes none), its launches counted under the route
``attention_query``; the aggregation is the same kernel with the attention
as its edge values, on ``att_feat``, the feature matrix's values layout
(``ops/attention_spmm.py``), forward and backward. The attention's parts are
spans: ``irt.attention.query`` and ``.aggregate`` here, ``.fold``,
``.scores``, ``.softmax`` and the backward ones in ``ops/``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from inductive_recommendation_tpu_torch.models.base import Linear, linear
from inductive_recommendation_tpu_torch.models.igcn import IGCN
from inductive_recommendation_tpu_torch.ops import spmm_csr, spmm_csr_values, values_layout
from inductive_recommendation_tpu_torch.ops.attention_spmm import fused_kv_attention
from inductive_recommendation_tpu_torch.utils.profiling import span


class AttIGCN(IGCN):
    def __init__(self, model_config, dataset, device):
        model_config = dict(model_config, feature_ratio=1.0)
        self.n_heads = int(model_config.get("n_heads", 4))
        super().__init__(model_config, dataset, device)
        d, h = self.embedding_size, self.n_heads
        self.weight_q = Linear(d, d * h, self.device)
        self.weight_k = Linear(d, d * h, self.device)
        self.temperature = math.sqrt(d) * 10.0

    def _build_graph_buffers(self, dataset):
        """IGCN's layouts at this model's alpha, 0 (also on a restore or an
        ``attach_dataset``), and the attention's values layout."""
        self.alpha = 0.0
        super()._build_graph_buffers(dataset)
        self.att_feat = values_layout(self.feat, route="attention")

    @torch.no_grad()
    def init_params(self, generator=None):
        super().init_params(generator)
        if hasattr(self, "weight_q"):  # not yet made during IGCN.__init__
            self.weight_q.reset(generator)
            self.weight_k.reset(generator)
        return self.params()

    def attention(self, params) -> torch.Tensor:
        """fp32 [nnz]: the head-mean attention on ``att_feat``'s edges."""
        d, h = self.embedding_size, self.n_heads
        emb = params["embedding"][: self.feat_n_cols]
        # the query aggregates the detached table with the alpha-0 weights
        # (row_sum^-1) baked into feat's values
        with span("irt.attention.query"):
            query_feat = dataclasses.replace(self.feat, route="attention_query")
            q = linear(params, "weight_q", spmm_csr(query_feat, emb.detach())).reshape(-1, h, d)
        return fused_kv_attention(self.att_feat, q, params["weight_k.w"], params["weight_k.b"], emb, self.temperature)

    def inductive_rep_layer(self, params, training=False, generator=None):
        """The attention aggregation of the (non-detached) table, the
        attention_spmm_fused_kv of the JAX model."""
        emb = params["embedding"][: self.feat_n_cols]
        attn = self.attention(params)
        with span("irt.attention.aggregate"):
            return spmm_csr_values(self.att_feat, emb, attn)

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        users_r, pos_r, neg_r, l2 = super().bpr_forward(
            params, users, pos_items, neg_items, training=training, generator=generator
        )
        l2 = l2 + (params["weight_q.w"] ** 2).sum() + (params["weight_k.w"] ** 2).sum()
        return users_r, pos_r, neg_r, l2
