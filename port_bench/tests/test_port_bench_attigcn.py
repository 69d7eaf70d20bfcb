"""The AttIGCN cell's own numbers at a tiny size on the CPU: two faults
planted in the program for this cell, which IGCN's checks cannot see at the
published temperature, read above their limits: a uniform attention (1/deg
on every edge) fails ``attn_gap``, and Wk's gradient dropped fails
``att_grad_gap``. And the readers of the ``irt.attention.*`` spans on a
trace made by hand."""

import importlib
import importlib.util
import types

import pytest
import torch

from conftest import ROOT

from port_bench.core import manifest as M
from port_bench.core.timing import Trace

CELL = "attigcn_gowalla.train"
SEED = 2**31 + 4099


def _one(root, seed):
    spec = importlib.util.spec_from_file_location("port_bench_calibrate", ROOT / "port_bench" / "calibrate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.one(root, CELL, seed, 0.3, "cpu")["numbers"]


def _uniform(mat, q, w_k, b_k, v, temperature):
    from inductive_recommendation_tpu_torch.ops.csr_spmm import row_of_edges

    deg = (mat.row_ptr[1:] - mat.row_ptr[:-1]).to(torch.float32)
    return (1.0 / deg)[row_of_edges(mat.row_ptr, mat.nnz).long()]


def test_a_uniform_attention_fails_attn_gap(tiny_root, monkeypatch):
    from inductive_recommendation_tpu_torch.models import att_igcn

    monkeypatch.setattr(att_igcn, "fused_kv_attention", _uniform)
    numbers = _one(tiny_root, SEED)
    limits = M.limits(ROOT, CELL)
    assert numbers["attn_gap"] > limits["attn_gap"], numbers
    assert numbers["attn_gap"] == pytest.approx(1.0, rel=0.05)


def test_wk_gradient_dropped_fails_att_grad_gap(tiny_root, monkeypatch):
    # the package exports a function of the module's name: take the module
    attention_spmm = importlib.import_module("inductive_recommendation_tpu_torch.ops.attention_spmm")
    fold = attention_spmm.folded_query
    monkeypatch.setattr(attention_spmm, "folded_query", lambda q, w_k, b_k, dv: fold(q, w_k.detach(), b_k, dv))
    numbers = _one(tiny_root, SEED + 1)
    limits = M.limits(ROOT, CELL)
    assert numbers["att_grad_gap"] > limits["att_grad_gap"], numbers
    assert numbers["att_grad_gap"] == pytest.approx(1.0)
    assert numbers["attn_gap"] <= limits["attn_gap"]  # the attention itself is sound


def test_sound_numbers_sit_far_below_the_limits(tiny_root):
    numbers = _one(tiny_root, SEED + 2)
    limits = M.limits(ROOT, CELL)
    for name in ("attn_gap", "att_grad_gap"):
        assert numbers[name] < 0.1 * limits[name], (name, numbers[name])


def test_the_attention_span_readers_take_every_attention_span():
    host = [
        (0.000, 0.010, "irt.train.forward"),
        (0.001, 0.003, "irt.attention.query"),
        (0.0015, 0.0016, "cudaLaunchKernel"),
        (0.003, 0.004, "irt.attention.scores"),
        (0.0035, 0.0036, "cudaLaunchKernel"),
        (0.005, 0.006, "cudaLaunchKernel"),  # in the forward, in no attention span
        (0.010, 0.020, "irt.train.backward"),
        (0.012, 0.015, "irt.attention.aggregate_backward"),
        (0.013, 0.014, "irt.ops.spmm"),
        (0.0131, 0.0132, "cudaLaunchKernel"),
        (0.016, 0.018, "irt.attention.scores_backward"),
        (0.0165, 0.0166, "cuLaunchKernel"),
    ]
    run = types.SimpleNamespace(trace=Trace(device=[], host=host, window_s=1.0, units=2, launches={}))
    assert M.reader(ROOT, "attention_ms.train")(run) == pytest.approx((2 + 1 + 3 + 2) / 2)
    assert M.reader(ROOT, "attention_launches.train")(run) == pytest.approx(4 / 2)
    bare = types.SimpleNamespace(trace=Trace(device=[], host=host[:1] + host[5:7], window_s=1.0, units=2,
                                             launches={}))
    assert M.reader(ROOT, "attention_ms.train")(bare) is None
    assert M.reader(ROOT, "attention_launches.train")(bare) is None
