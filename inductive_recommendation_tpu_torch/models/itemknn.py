"""ItemKNN (reference model.py:4058-4088; counterpart of
``inductive_recommendation_tpu/models/itemknn.py``): Jaccard item-item
similarity, the top-k neighbours of every item, and a user's scores its
profile times the similarity matrix.

The similarity is built on the device in blocks of items: a block's
intersections with every item are one product of R^T (items x users)
against the block's dense [n_users, block] user columns, through the SpMM
kernel at d = block; the Jaccard is elementwise and ``torch.topk`` keeps k
neighbours per item. The kept (item, neighbour, value) triples become S^T as
a CSR on the device (sorted by neighbour with a stable sort, ``row_ptr`` by
``bincount``), with no host copy of its k * n_items edges. Scoring is
``spmm(S^T, profiles^T)^T``, the kernel at d = the user batch.

Ties (documented divergence, as in the JAX package): the reference's
``np.argsort(sims)[-k:]`` and JAX's ``lax.top_k`` choose among exactly tied
similarities by index, and ``torch.topk`` makes no promise: the neighbour
sets agree except among items tied at the k-th value.
"""

from __future__ import annotations

import numpy as np
import torch

from inductive_recommendation_tpu_torch.data.dataset import device_padded_from_lists
from inductive_recommendation_tpu_torch.models.base import BasicModel
from inductive_recommendation_tpu_torch.ops import CsrSpMM, build_csr_spmm, spmm_csr
from inductive_recommendation_tpu_torch.ops.csr_spmm import csr_on_device
from inductive_recommendation_tpu_torch.utils.profiles import dense_profiles


class ItemKNN(BasicModel):
    trainable = False

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.k = model_config["k"]
        self.block = model_config.get("sim_block", 512)
        self.sim_t = self.build_similarity(dataset)
        self.train_padded = device_padded_from_lists(dataset.train_data, self.n_items, device=self.device)

    def similarity_inputs(self, dataset):
        """(R^T CSR [n_items, n_users] of the deduplicated train pairs, fp32
        item degrees) on the model's device. Duplicated pairs are coalesced:
        the Jaccard numerator counts a shared user once (JAX
        ``itemknn.py:45-49``)."""
        pairs = np.unique(np.asarray(dataset.train_array, dtype=np.int64).reshape(-1, 2), axis=0)
        users, items = pairs[:, 0], pairs[:, 1]
        rt = build_csr_spmm(
            items, users, np.ones(len(items), np.float32), (self.n_items, self.n_users), device=self.device
        )
        degree = torch.as_tensor(np.bincount(items, minlength=self.n_items).astype(np.float32), device=self.device)
        return rt, degree

    def block_columns(self, rt, start, stop) -> torch.Tensor:
        """fp32 [n_users, stop - start]: column j is item start + j's users."""
        ptr = rt.row_ptr[start : stop + 1].long()
        item = torch.repeat_interleave(torch.arange(stop - start, device=self.device), torch.diff(ptr))
        cols = torch.zeros(self.n_users, stop - start, dtype=torch.float32, device=self.device)
        cols[rt.col[int(ptr[0]) : int(ptr[-1])].long(), item] = 1.0
        return cols

    def block_topk(self, rt, degree, start, stop, k):
        """(values, neighbour ids), each [stop - start, k], of items start..stop."""
        inter = spmm_csr(rt, self.block_columns(rt, start, stop))  # [n_items, block]
        denom = degree[:, None] + degree[None, start:stop] - inter
        sims = torch.where(denom > 0, inter / torch.clamp(denom, min=1e-12), 0.0)
        sims = torch.where(degree[:, None] > 0, sims, 0.0)
        return torch.topk(sims.T, k, dim=1)

    @torch.no_grad()
    def build_similarity(self, dataset) -> CsrSpMM:
        """S^T [n_items, n_items]: S holds item i's k most similar items."""
        rt, degree = self.similarity_inputs(dataset)
        k = min(self.k, self.n_items)
        rows, cols, vals = [], [], []
        for start in range(0, self.n_items, self.block):
            stop = min(start + self.block, self.n_items)
            top_v, top_i = self.block_topk(rt, degree, start, stop, k)
            rows.append(torch.arange(start, stop, device=self.device).repeat_interleave(k))
            cols.append(top_i.reshape(-1))
            vals.append(top_v.reshape(-1))
        # scoring computes P @ S as (S^T @ P^T)^T: S^T's rows are S's columns
        return csr_on_device(torch.cat(cols), torch.cat(rows), torch.cat(vals), (self.n_items, self.n_items))

    def init_params(self, generator=None):
        return {}

    def make_scoring_state(self, params):
        return None

    def score(self, state, users):
        profiles = dense_profiles(self.train_padded, users, self.n_items)
        return spmm_csr(self.sim_t, profiles.T.contiguous()).T
