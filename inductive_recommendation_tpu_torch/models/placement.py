"""Where a model's forward pass runs: the operators it takes from its
placement (``BasicModel.placement``).

A model writes its forward pass once, against five things that depend on
where its layouts and rows live:

- the sparse products over its layouts (``spmm``, ``spmm_dropout``,
  ``spmm_values``, ``propagate_mean``), each layout passed whole, as the
  model holds it;
- the rows of a batch (``rows``, ``batch_rows``);
- replicated weights applied to the rows a rank holds (``shared``);
- a tensor over a layout's rows cut to the rows a rank holds
  (``local_rows``, ``first_row``);
- AttIGCN's attention on a layout's edges (``attention``);

and ``gather``, the whole representation for scoring.

:class:`LocalPlacement` is one device: each operator is the single-device
op it names, and the cuts and ``gather`` return their input, so a forward
pass issues the same torch ops as one written against the ops directly.
Edge mode supplies another placement (``parallel/placement.py``), whose
operators run on this rank's shards of the same layouts.
"""

from __future__ import annotations

from inductive_recommendation_tpu_torch.ops import propagate_mean, spmm_csr, spmm_csr_dropout, spmm_csr_values


class LocalPlacement:
    """Every layout and row on one device."""

    def spmm(self, mat, x):
        return spmm_csr(mat, x)

    def spmm_dropout(self, mat, x, seed: int, p: float):
        return spmm_csr_dropout(mat, x, seed, p)

    def spmm_values(self, mat, x, values):
        return spmm_csr_values(mat, x, values)

    def propagate_mean(self, mat, x0, n_layers: int):
        return propagate_mean(mat, x0, n_layers)

    def rows(self, t, ids):
        """``t[ids]``."""
        return t[ids]

    def batch_rows(self, t, users, pos, neg, offset: int):
        """A BPR batch's rows: ``t[users]``, ``t[offset + pos]``,
        ``t[offset + neg]``, three index ops."""
        return t[users], t[offset + pos], t[offset + neg]

    def shared(self, params, names):
        """``params``, whose replicated weights ``names`` apply to the rows
        held here: all of them."""
        return params

    def local_rows(self, t, mat, operand: bool = False):
        """The rows held here of ``t``, a tensor over ``mat``'s rows (or its
        operand's, with ``operand``): all of them."""
        return t

    def first_row(self, t) -> int:
        """The whole row index of ``t``'s first row: 0."""
        return 0

    def attention(self, op, mat, q, w_k, b_k, v, temperature: float):
        """The attention on ``mat``'s edges: ``op``, the single-device
        attention (``ops.attention_spmm.fused_kv_attention``)."""
        return op(mat, q, w_k, b_k, v, temperature)

    def gather(self, rep, n_rows: int):
        """The whole representation: ``rep``."""
        return rep


LOCAL = LocalPlacement()
