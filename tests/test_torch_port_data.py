"""The PyTorch port's data preparation against the JAX package: the raw
Gowalla / Yelp / Amazon parsers, the k-core, the chronological split with the
reference's quirks, the written train/val/test files, ``SyntheticDataset``,
``ProcessedDataset``, the native graph core against its plain versions, the
edge-set helpers and ``device_sym_normalize``.

Both packages read the same files, written by the tests from numpy seeds.
Datasets, lists and files must be identical; ``device_sym_normalize`` is held
within 1e-6 (fp32 sums in a different order)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inductive_recommendation_tpu import native as jax_native
from inductive_recommendation_tpu.data import dataset as JD
from inductive_recommendation_tpu.graph import build as jax_build
from inductive_recommendation_tpu.utils import set_seed as jax_set_seed
from inductive_recommendation_tpu_torch import native
from inductive_recommendation_tpu_torch.data import dataset as PD
from inductive_recommendation_tpu_torch.graph import build as port_build
from inductive_recommendation_tpu_torch.utils import set_seed

SPLIT = [0.7, 0.15, 0.15]


def gowalla_lines(rng, n_users=30, n_items=24, n_events=500):
    """user \\t ISO time \\t lat \\t lon \\t item, with repeated (u, i) pairs
    at later (and earlier) times, and short-history users that survive the
    k-core but have int(n * 0.15) == 0 (the ``lst[-0:]`` quirk)."""
    lines = []
    for _ in range(n_events):
        u, i = int(rng.integers(0, n_users)), int(rng.integers(0, n_items))
        t = "2010-%02d-%02dT%02d:%02d:00Z" % (rng.integers(1, 13), rng.integers(1, 28), rng.integers(24), rng.integers(60))
        lines.append(f"{u}\t{t}\t{rng.normal():.6f}\t{rng.normal():.6f}\t{i}")
    for k, n_short in enumerate((3, 4, 5)):
        for j in range(n_short):
            lines.append(f"{n_users + k}\t2010-06-{10 + j:02d}T12:00:00Z\t0.0\t0.0\t{j}")
    lines.append(f"{n_users + 9}\t2010-06-01T00:00:00Z\t0.0\t0.0\t{n_items + 9}")  # cut by the k-core
    return lines


def yelp_line(u, b, stars, date, text='a \\"quoted\\" text, with commas'):
    return ('{"review_id":"r","user_id":"%s","business_id":"%s","stars":%s,"useful":0,'
            '"text":"%s","date":"%s"}' % (u, b, stars, text, date))


def yelp_lines(rng, decline=False):
    lines = []
    for _ in range(400):
        u, b = "u%02d" % rng.integers(14), "b%02d" % rng.integers(10)
        stars = ["1.0", "2.0", "3.0", "4.0", "5.0", "4", "3.5"][rng.integers(7)]
        date = "20%02d-%02d-%02d %02d:%02d:%02d" % (
            rng.integers(10, 20), rng.integers(1, 13), rng.integers(1, 28),
            rng.integers(24), rng.integers(60), rng.integers(60),
        )
        lines.append(yelp_line(u, b, stars, date, 'nice, \\"date\\":\\"2001-01-01 00:00:00 haha'))
    if decline:  # an escaped quote in an id: the native parser declines the file
        lines.append(yelp_line('u\\"x', "b00", "5.0", "2015-01-01 00:00:00"))
    return lines


def amazon_lines(rng, decline=False):
    lines, t = [], 1_400_000_000
    for _ in range(400):
        t += int(rng.integers(-500, 1000))
        r = ["1.0", "2.0", "3.0", "4.0", "5.0", "5"][rng.integers(6)]
        lines.append("A%03dXYZ,00000%03d,%s,%d" % (rng.integers(14), rng.integers(10), r, t))
    if decline:  # a rating with an exponent: the native parser declines, float() reads it
        lines.append("A000XYZ,00000000,4e0,%d" % (t + 1))
    return lines


RAW = {
    "GowallaDataset": ("Gowalla_totalCheckins.txt", lambda rng, decline: gowalla_lines(rng)),
    "YelpDataset": ("yelp_academic_dataset_review.json", yelp_lines),
    "AmazonDataset": ("ratings_Books.csv", amazon_lines),
}


def write_raw(tmp_path, name, seed, decline=False):
    file_name, make = RAW[name]
    (tmp_path / file_name).write_text("\n".join(make(np.random.default_rng(seed), decline)) + "\n")
    return {"name": name, "path": str(tmp_path), "min_inter": 3, "split_ratio": list(SPLIT)}


def assert_same_dataset(port, ref):
    assert (port.n_users, port.n_items) == (ref.n_users, ref.n_items)
    assert port.train_data == ref.train_data
    assert port.val_data == ref.val_data
    assert port.test_data == ref.test_data
    np.testing.assert_array_equal(np.asarray(port.train_array).reshape(-1, 2),
                                  np.asarray(ref.train_array, dtype=np.int64).reshape(-1, 2))


def assert_same_files(tmp_path, port, ref):
    port.output_dataset(str(tmp_path / "port"))
    ref.output_dataset(str(tmp_path / "jax"))
    for split in ("train", "val", "test"):
        assert (tmp_path / "port" / f"{split}.txt").read_bytes() == (tmp_path / "jax" / f"{split}.txt").read_bytes()


@pytest.mark.parametrize(
    "name, decline",
    [("GowallaDataset", False), ("YelpDataset", False), ("YelpDataset", True), ("AmazonDataset", False),
     ("AmazonDataset", True)],
)
def test_raw_dataset_matches_jax(tmp_path, name, decline):
    """Each raw parser, native and (where the native parser declines) the
    exact Python path, gives the JAX package's dataset and files."""
    cfg = write_raw(tmp_path, name, seed=7, decline=decline)
    port, ref = PD.get_dataset(cfg), JD.get_dataset(cfg)
    assert_same_dataset(port, ref)
    assert port.n_users > 5 and port.n_items > 5
    assert_same_files(tmp_path, port, ref)


@pytest.mark.parametrize("name", sorted(RAW))
def test_python_parsers_match_jax(tmp_path, name, monkeypatch):
    """With the native library unavailable, every path runs its plain
    version, and the result is still the JAX package's."""
    cfg = write_raw(tmp_path, name, seed=8)
    ref = JD.get_dataset(cfg)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert_same_dataset(PD.get_dataset(cfg), ref)


def test_gowalla_quirks_are_exercised(tmp_path):
    """The file has short-history users (empty val, the whole list as test,
    train items included) and repeated pairs keeping the earliest time."""
    cfg = write_raw(tmp_path, "GowallaDataset", seed=7)
    ds = PD.get_dataset(cfg)
    quirk = [u for u in range(ds.n_users) if int(len(ds.test_data[u]) * SPLIT[2]) == 0 and not ds.val_data[u]
             and ds.train_data[u] and set(ds.train_data[u]) <= set(ds.test_data[u])]
    assert len(quirk) >= 3
    users, items, _ = native.parse_gowalla_file(str(tmp_path / "Gowalla_totalCheckins.txt"))
    assert len(np.unique(users * 10_000 + items)) < len(users)


@pytest.mark.parametrize("name", sorted(RAW))
def test_shuffled_split_files_match_jax(tmp_path, name):
    """``shuffle`` draws from the global ``np.random`` stream after
    ``set_seed``, user by user, as the JAX package does: the files are
    byte-identical, and differ from the unshuffled ones."""
    cfg = dict(write_raw(tmp_path, name, seed=9), shuffle=True)
    set_seed(5)
    port = PD.get_dataset(cfg)
    jax_set_seed(5)
    ref = JD.get_dataset(cfg)
    assert_same_dataset(port, ref)
    assert_same_files(tmp_path, port, ref)
    assert port.train_data != PD.get_dataset(dict(cfg, shuffle=False)).train_data


@pytest.mark.parametrize("min_inter", [None, 2, 4])
def test_synthetic_dataset_matches_jax(min_inter):
    cfg = {"name": "SyntheticDataset", "n_users": 60, "n_items": 45, "n_interactions": 900, "seed": 3,
           "split_ratio": [0.8, 0.1, 0.1]}
    if min_inter is not None:
        cfg["min_inter"] = min_inter
    port, ref = PD.get_dataset(cfg), JD.get_dataset(cfg)
    assert_same_dataset(port, ref)
    if min_inter is None:
        assert port.n_users == 60


def test_processed_dataset_matches_jax(tmp_path):
    cfg = write_raw(tmp_path, "GowallaDataset", seed=11)
    JD.get_dataset(cfg).output_dataset(str(tmp_path / "split"))
    pcfg = {"name": "ProcessedDataset", "path": str(tmp_path / "split")}
    port, ref = PD.get_dataset(pcfg), JD.get_dataset(pcfg)
    assert_same_dataset(port, ref)
    assert port.read_data(str(tmp_path / "split" / "val.txt")) == ref.read_data(str(tmp_path / "split" / "val.txt"))


def test_missing_min_inter_raises(tmp_path):
    cfg = write_raw(tmp_path, "GowallaDataset", seed=7)
    del cfg["min_inter"]
    with pytest.raises(ValueError, match="min_inter"):
        PD.get_dataset(cfg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kcore_native_numpy_and_jax_agree(seed):
    rng = np.random.default_rng(seed)
    n_users, n_items = 300, 200
    u = rng.choice(n_users, 4000, p=np.arange(1, n_users + 1) ** -0.6 / (np.arange(1, n_users + 1) ** -0.6).sum())
    i = rng.choice(n_items, 4000, p=np.arange(1, n_items + 1) ** -0.8 / (np.arange(1, n_items + 1) ** -0.8).sum())
    pairs = np.unique(u * n_items + i)
    users, items = pairs // n_items, pairs % n_items
    assert native.native_available()
    got = native.kcore_masks(users, items, n_users, n_items, 5)
    plain = native.kcore_masks_reference(users, items, n_users, n_items, 5)
    ref = jax_native.kcore_masks(users, items, n_users, n_items, 5)
    for a, b, c in zip(got, plain, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert 0 < got[0].sum() < n_users and 0 < got[1].sum() < n_items


def test_native_parsers_match_plain(tmp_path):
    """The Gowalla and adjacency parsers against their plain versions, the
    library built from the port's own copy of the source."""
    assert native.library_path().parent == native.BUILD_DIR
    path = tmp_path / "g.txt"
    path.write_text("\n".join(gowalla_lines(np.random.default_rng(4))) + "\n")
    for a, b in zip(native.parse_gowalla_file(str(path)), native.parse_gowalla_reference(str(path))):
        np.testing.assert_array_equal(a, b)
    adj = tmp_path / "adj.txt"
    adj.write_text("\n0 3 4\n1\n\n3 7 8 9\n4 1\n\n")  # interior blank lines are empty rows
    for a, b in zip(native.parse_adjacency_file(str(adj)), native.parse_adjacency_reference(str(adj))):
        np.testing.assert_array_equal(a, b)
    assert native.parse_adjacency_file(str(adj))[1].tolist() == [0, 2, 2, 2, 5, 6]


def test_native_declines(tmp_path):
    path = tmp_path / "y.json"
    path.write_text(yelp_line("u0", "b0", "4.0", "2015-1-1 0:0:0") + "\n")
    assert native.parse_yelp_file(str(path)) is None
    path = tmp_path / "a.csv"
    path.write_text("u0,i0,4.0,123,extra\n")
    assert native.parse_amazon_file(str(path)) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_set_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    train = np.stack([rng.integers(0, 30, 200), rng.integers(0, 40, 200)], axis=1)
    aug = np.stack([rng.integers(0, 30, 60), rng.integers(0, 40, 60)], axis=1)
    np.testing.assert_array_equal(port_build._dedupe_edges(train), jax_build._dedupe_edges(train))
    np.testing.assert_array_equal(port_build.drop_union_edges(train, aug), jax_build.drop_union_edges(train, aug))
    np.testing.assert_array_equal(port_build.drop_difference_edges(train, aug),
                                  jax_build.drop_difference_edges(train, aug))
    np.testing.assert_array_equal(port_build.drop_difference_edges(train, aug[:0]),
                                  jax_build.drop_difference_edges(train, aug[:0]))
    np.testing.assert_array_equal(port_build.drop_sample_edges(train, 0.7, np.random.default_rng(seed)),
                                  jax_build.drop_sample_edges(train, 0.7, np.random.default_rng(seed)))


def test_device_sym_normalize_matches_jax():
    rng = np.random.default_rng(5)
    n_nodes, n_edges = 50, 400
    row, col = rng.integers(0, n_nodes, n_edges), rng.integers(0, n_nodes, n_edges)
    mask = (rng.random(n_edges) < 0.8).astype(np.float32)
    ref = np.asarray(jax_build.device_sym_normalize(jnp.asarray(row), jnp.asarray(col), jnp.asarray(mask), n_nodes))
    got = port_build.device_sym_normalize(torch.as_tensor(row), torch.as_tensor(col), torch.as_tensor(mask), n_nodes)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert got[torch.as_tensor(mask) == 0].abs().max() == 0


def test_reference_forms_match_jax():
    """The per-interaction helpers, ported as the reference of the
    vectorized split, give the JAX package's lists."""
    rng = np.random.default_rng(6)
    triples = [(int(u), int(i), int(t)) for u, i, t in
               zip(rng.integers(0, 8, 120), rng.integers(0, 9, 120), rng.integers(0, 50, 120))]
    user_map, item_map = {u: k for k, u in enumerate(range(7))}, {i: k for k, i in enumerate(range(1, 9))}
    got = PD.build_user_inter_lists(iter(triples), user_map, item_map, 7)
    assert got == JD.build_user_inter_lists(iter(triples), user_map, item_map, 7)
    one = [[] for _ in range(7)]
    for u, i, t in triples:
        PD.update_user_inter_lists(u, i, t, user_map, item_map, one)
    assert one == got
    sets_p, sets_j = ({}, {}), ({}, {})
    for u, i, _ in triples:
        PD.update_ui_sets(u, i, *sets_p)
        JD.update_ui_sets(u, i, *sets_j)
    assert sets_p == sets_j
