"""The PyTorch port's host-side graph builders and datasets against the JAX
package, on the same numpy inputs: the arrays must be exactly equal (the
builders are numpy copies, so no tolerance applies). Also checks that the port
imports neither JAX nor the JAX package."""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inductive_recommendation_tpu.data.dataset as jdata
import inductive_recommendation_tpu.graph.build as jbuild
import inductive_recommendation_tpu_torch.data.dataset as tdata
import inductive_recommendation_tpu_torch.graph.build as tbuild

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "inductive_recommendation_tpu_torch"


@pytest.fixture(scope="module")
def ds_pair():
    args = (200, 150, 3000)
    return jdata.quick_synthetic_dataset(*args, seed=0), tdata.quick_synthetic_dataset(*args, seed=0)


def test_quick_synthetic_dataset_identical(ds_pair):
    jd, td = ds_pair
    assert (jd.n_users, jd.n_items) == (td.n_users, td.n_items)
    np.testing.assert_array_equal(jd.train_array, td.train_array)
    assert jd.train_array.dtype == td.train_array.dtype
    for split in ("train_data", "val_data", "test_data"):
        assert getattr(jd, split) == getattr(td, split)
    assert len(jd) == len(td)


def test_adjacency_builders_identical(ds_pair):
    jd, td = ds_pair
    n = jd.n_users + jd.n_items
    for a, b in zip(
        jbuild.bipartite_edges(jd.train_array, jd.n_users, jd.n_items),
        tbuild.bipartite_edges(td.train_array, td.n_users, td.n_items),
    ):
        np.testing.assert_array_equal(a, b)
    row, col = tbuild.bipartite_edges(td.train_array, td.n_users, td.n_items)
    for name in ("sym_normalize_values", "row_l1_normalize_values"):
        a = getattr(jbuild, name)(row, col, n)
        b = getattr(tbuild, name)(row, col, n)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # repeated pairs coalesce into multiplicities on both sides
    doubled = np.concatenate([jd.train_array, jd.train_array[:50]])
    for a, b in zip(
        jbuild.sym_normalized_adjacency(doubled, jd.n_users, jd.n_items),
        tbuild.sym_normalized_adjacency(doubled, td.n_users, td.n_items),
    ):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_feat_matrix_builder_identical(ds_pair):
    jd, td = ds_pair
    rng = np.random.default_rng(1)
    user_map = np.where(rng.random(jd.n_users) < 0.8, 0, -1)
    user_map[user_map >= 0] = np.arange((user_map >= 0).sum())
    item_map = np.where(rng.random(jd.n_items) < 0.7, 0, -1)
    item_map[item_map >= 0] = np.arange((item_map >= 0).sum())
    a = jbuild.build_feat_matrix(jd.train_array, jd.n_users, jd.n_items, user_map, item_map)
    b = tbuild.build_feat_matrix(td.train_array, td.n_users, td.n_items, user_map, item_map)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    row, _, counts, row_sum = b
    for alpha in (1.0, 0.99**2, 0.5):
        j = np.asarray(jbuild.feat_values_for_alpha(jnp.asarray(row), jnp.asarray(counts), jnp.asarray(row_sum), alpha))
        # fp32 pow in numpy and in XLA may round apart by one unit in the last place
        np.testing.assert_allclose(tbuild.feat_values_for_alpha(row, counts, row_sum, alpha), j, rtol=2e-7, atol=0)
        tv = tbuild.feat_values_for_alpha(torch.as_tensor(row), torch.as_tensor(counts), torch.as_tensor(row_sum), alpha)
        np.testing.assert_allclose(tv.numpy(), j, rtol=2e-7, atol=0)


def test_processed_dataset_reader_identical(tmp_path, ds_pair):
    jd, _ = ds_pair
    train = [list(t) for t in jd.train_data]
    train[3] = []  # an interior user with no items is an empty row, not a skipped line
    for name, lists in (("train", train), ("val", jd.val_data), ("test", jd.test_data)):
        jdata.output_data(str(tmp_path / f"{name}.txt"), lists)
    cfg = {"name": "ProcessedDataset", "path": str(tmp_path)}
    a, b = jdata.get_dataset(cfg), tdata.get_dataset(cfg)
    assert (a.n_users, a.n_items) == (b.n_users, b.n_items)
    np.testing.assert_array_equal(a.train_array, b.train_array)
    for split in ("train_data", "val_data", "test_data"):
        assert getattr(a, split) == getattr(b, split)


@pytest.mark.parametrize("pad_to", [None, 64])
def test_padded_user_lists_identical(ds_pair, pad_to):
    jd, td = ds_pair
    lists = [list(t) for t in jd.train_data]
    lists[0] = []
    for sort in (True, False):
        a = jdata.pad_user_lists(lists, jd.n_items, pad_to=pad_to, sort=sort)
        b = tdata.pad_user_lists(lists, td.n_items, pad_to=pad_to, sort=sort)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    a = np.asarray(jdata.device_padded_from_lists(lists, jd.n_items, pad_to=pad_to))
    b = tdata.device_padded_from_lists(lists, td.n_items, pad_to=pad_to, device="cpu")
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(ValueError):
        tdata.device_padded_from_lists(lists, td.n_items, pad_to=1, device="cpu")


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port; JAX stays unloaded."""
    modules = sorted(
        "inductive_recommendation_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'inductive_recommendation_tpu' or m.startswith('inductive_recommendation_tpu.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_port_source_names_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|jaxlib\b|inductive_recommendation_tpu(\.|\s|$))", re.MULTILINE
    )
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
