"""The benchmark's frozen data maker against the program's generator, and
the inductive arrival sets."""

import numpy as np

from port_bench.core import data as D


def test_synthetic_equals_the_programs_generator():
    from inductive_recommendation_tpu_torch.data.dataset import quick_synthetic_dataset

    for seed in (0, 3):
        ours = D.synthetic(300, 400, 6000, seed)
        theirs = quick_synthetic_dataset(300, 400, 6000, seed=seed)
        assert (ours.n_users, ours.n_items) == (theirs.n_users, theirs.n_items)
        for split in ("train", "val", "test"):
            assert ours.lists(split) == getattr(theirs, split + "_data")
        np.testing.assert_array_equal(ours.train_array, theirs.train_array)


def test_same_seed_same_data_large_seed():
    big = 2**31 + 12345
    a, b = D.synthetic(200, 300, 3000, D.seed_words(big, 1)), D.synthetic(200, 300, 3000, D.seed_words(big, 1))
    np.testing.assert_array_equal(a.train_array, b.train_array)
    c = D.synthetic(200, 300, 3000, D.seed_words(big + 1, 1))
    assert not np.array_equal(a.train_array, c.train_array)


def test_arrival_sets_share_the_old_part_and_the_shape():
    full = D.synthetic(300, 400, 6000, 5)
    sets = D.arrival_sets(full, 270, 280, 2, 9)
    old = [D.old_part(s, 270, 280) for s in sets]
    for split in ("train", "val", "test"):
        assert old[0].lists(split) == old[1].lists(split) == D.old_part(full, 270, 280).lists(split)
    a, b = (s.train_array for s in sets)
    assert len(a) == len(b) == len(full.train_array)
    assert not np.array_equal(a, b)
    # the same degrees, so the same work: the sorted degree sequences agree
    for s in sets:
        np.testing.assert_array_equal(np.sort(np.diff(s.train[1])), np.sort(np.diff(full.train[1])))
