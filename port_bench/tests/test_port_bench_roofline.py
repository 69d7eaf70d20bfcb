"""The yardstick's counts against shapes worked by hand."""

import pytest

from port_bench.core import roofline as R


def test_spmm_counts():
    w = R.spmm(10, 20, 100, 8)
    assert w.ops == 2 * 100 * 8
    assert w.bytes == 4 * 11 + 8 * 100 + 4 * 8 * (20 + 10)
    d = R.spmm(10, 20, 100, 8, dropout=True)
    assert d.ops == (2 * 8 + 100) * 100 and d.bytes == 4 * 11 + 12 * 100 + 4 * 8 * 30


def test_least_time_is_the_larger_bound():
    assert R.Work(67e12, 0).least_s == pytest.approx(1.0)
    assert R.Work(0, 3.35e12).least_s == pytest.approx(1.0)
    assert R.Work(67e12, 6.7e12).least_s == pytest.approx(2.0)


def test_score_gemm_at_gowalla():
    # 2 * 29,858 * 40,981 * 64 operations at 67 TFLOP/s: 2.337 ms
    w = R.score_gemm(29858, 40981, 64)
    assert w.ops == 2 * 29858 * 40981 * 64
    assert w.least_s == pytest.approx(2 * 29858 * 40981 * 64 / 67e12)
    assert w.least_s == pytest.approx(2.3372e-3, rel=1e-3)


def test_igcn_step_by_hand():
    s = {"n_nodes": 10, "feat_cols": 12, "feat_nnz": 30, "adj_nnz": 40, "d": 4, "n_layers": 2, "batch": 3,
         "table_rows": 12}
    w = R.igcn_step(s, None)
    feat = R.spmm(10, 12, 30, 4, True) + R.spmm(12, 10, 30, 4, True)
    layers = R.spmm(10, 10, 40, 4) * 4
    mean = R.elementwise(40, 3, 1, 3) * 2
    batch = R.elementwise(6 * 3 * 4, 1, 1, 4)
    adam = R.elementwise(12 * 4 + 4, 4, 3, 12)
    want = feat + layers + mean + batch + adam
    assert w.ops == pytest.approx(want.ops) and w.bytes == pytest.approx(want.bytes)
    dose = R.igcn_step(s, 50)
    extra = feat + R.spmm(10, 10, 50, 4) * 4 + mean + R.Work(3 * 2.0 * 9 * 4, 4 * (2 * 3 * 4 + 2 * 9))
    assert dose.ops == pytest.approx(want.ops + extra.ops)


def test_eval_pass_holds_the_gemm():
    s = {"n_nodes": 10, "feat_cols": 12, "feat_nnz": 30, "adj_nnz": 40, "d": 4, "n_layers": 2}
    w = R.eval_pass(s, 4, 6, 3, 2)
    assert w.ops > R.score_gemm(4, 6, 4).ops
    assert w.least_s >= R.score_gemm(4, 6, 4).least_s
