"""The attention's counts (``core/attention_work.py``) against shapes
worked by hand, and the kernel names of a device trace priced by call."""

import pytest

from port_bench.core import attention_work as A
from port_bench.core import roofline as R

S = {"n_rows": 10, "n_cols": 12, "nnz": 30, "d": 4, "heads": 2, "adj_nnz": 40, "n_layers": 2}


def test_sddmm_counts():
    w = A.sddmm(10, 12, 30, 2, 4, True)
    assert w.ops == 2 * 2 * 4 * 30
    assert w.bytes == 4 * (11 + 30) + 4 * (10 * 2 * 4 + 12 * 4 + 30 * 2 + 10 * 2)
    d = A.sddmm(10, 12, 30, 1, 4, False)
    assert d.ops == 2 * 4 * 30 and d.bytes == 4 * (11 + 30) + 4 * (10 * 4 + 12 * 4 + 30)


def test_sddmm_backward_counts():
    w = A.sddmm_backward(10, 12, 30, 2, 4)
    assert w.ops == (2 * 4 + 1) * 2 * 30
    assert w.bytes == 4 * (11 + 30) + 4 * (30 * 2 + 12 * 4 + 10 * 2 * 4 + 10 * 2)


def test_softmax_passes_count_10_and_5_an_entry():
    calls = A.kernel_calls(S)
    fwd = calls["softmax_stats"].ops + calls["softmax_apply"].ops
    bwd = calls["softmax_stats_backward"].ops + calls["softmax_apply_backward"].ops
    assert fwd == 10 * 30 * 2 and bwd == 5 * 30 * 2
    assert calls["softmax_stats"].bytes == 4 * 11 + 4 * (30 * 2 + 2 * 10 * 2)
    assert calls["softmax_apply"].bytes == 4 * 11 + 4 * (2 * 30 * 2 + 2 * 10 * 2 + 30)
    assert calls["softmax_stats_backward"].bytes == 4 * 11 + 4 * (30 * 2 + 30 + 10 * 2)
    assert calls["softmax_apply_backward"].bytes == 4 * 11 + 4 * (2 * 30 * 2 + 30 + 10 * 2)


def test_five_gemms_at_gowalla():
    s = {"n_rows": 70839, "n_cols": 70841, "nnz": 1864173, "d": 64, "heads": 4}
    w = A.gemms(s)
    assert w.ops == 5 * 2 * 70839 * 64 * 256
    # Wq forward: [n, 64] @ [64, 256]; the fold and d(q): 4 heads of [n, 64] @ [64, 64];
    # d(Wk): 4 of [64, n] @ [n, 64]; d(Wq): [64, n] @ [n, 256]
    want = (4 * (70839 * 64 + 64 * 256 + 70839 * 256) + 2 * 4 * 4 * (70839 * 64 + 64 * 64 + 70839 * 64)
            + 4 * 4 * (64 * 70839 + 70839 * 64 + 64 * 64) + 4 * (64 * 70839 + 70839 * 256 + 64 * 256))
    assert w.bytes == want
    assert w.least_s == pytest.approx(5 * 2 * 70839 * 64 * 256 / 67e12, rel=0.3)


def test_step_holds_every_part():
    s = dict(S, batch=3, table_rows=12)
    w = A.step(s)
    n, c, e, d, h = 10, 12, 30, 4, 2
    want = R.spmm(n, c, e, d) * 2 + R.spmm(c, n, e, d) + A.gemms(s)
    for call in A.kernel_calls(s).values():
        want = want + call
    want = want + R.spmm(n, n, 40, d) * 4 + R.elementwise(n * d, 3, 1, 3) * 2 + R.elementwise(6 * 3 * d, 1, 1, 4)
    want = want + R.adam(12 * d + d + 2 * (d * h * d + h * d))
    assert w.ops == pytest.approx(want.ops) and w.bytes == pytest.approx(want.bytes)


def test_kernel_share_prices_each_launch_by_its_call():
    calls = A.kernel_calls(S)
    ev = [
        (0.0, 1.0, "void (anonymous namespace)::sddmm_vec_kernel<16, 2>(int const*, int const*)"),
        (1.0, 2.0, "void (anonymous namespace)::sddmm_vec_kernel<16, 1>(int const*, int const*)"),
        (2.0, 3.0, "void (anonymous namespace)::sddmm_bwd_chunk_kernel<16, 4, 2>(int const*)"),
        (3.0, 3.5, "void (anonymous namespace)::sddmm_bwd_carry_kernel<16, 4>(int const*)"),
        (4.0, 5.0, "void (anonymous namespace)::softmax_stats_chunk_kernel<false, true, 2>(int const*)"),
        (5.0, 5.5, "void (anonymous namespace)::softmax_stats_carry_kernel<false, 2>(int const*)"),
        (6.0, 7.0, "void (anonymous namespace)::softmax_apply_kernel<false, true, 2>(int const*)"),
        (7.0, 8.0, "void (anonymous namespace)::softmax_stats_chunk_kernel<true, true, 2>(int const*)"),
        (8.0, 9.0, "void (anonymous namespace)::softmax_apply_kernel<true, true, 2>(int const*)"),
        (9.0, 10.0, "void spmm_chunk_kernel<true>(int const*)"),
        (10.0, 11.0, "ampere_sgemm_128x64_nn"),
    ]
    least, device = A.kernel_share(ev, S)
    assert device == pytest.approx(8.0)  # the SpMM and the GEMM left out
    assert least == pytest.approx(sum(c.least_s for c in calls.values()))
    assert A.kernel_share([], S) == (0.0, 0.0)
