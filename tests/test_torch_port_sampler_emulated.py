"""The BPR batch draw's kernel (``ops/csrc/bpr_sample.cu``) run on the CPU
through the host shim of ``test_torch_port_softmax_emulated.py``: g++ builds
the source against it, and ``data/sampling.py::sample_bpr_batch_cuda`` calls
its C entry point through ctypes on CPU tensors (the library loader, the
current device and the stream stubbed), as it calls it on the card.

The batch is held bitwise to the plain version (``sample_bpr_batch`` on CPU
tensors) drawn from a clone of the same generator state, and both leave the
generator in the same state; and bitwise to the JAX package's
``sample_bpr_batch`` handed the same three draws. Cases: neg_ratio 1 and 4; a user holding the
whole catalog (the clamped id n_items - 1); duplicated train items (dropped
when the state is built); users with no train item (never drawn); degree 1;
a user at the largest degree (the deepest search); B = 1; B not a multiple
of the kernel's block of 256 threads. The wrapper counts one launch a draw.

This checks the kernel's logic and the wrapper's arguments, not their speed:
``chip_smoke.py`` holds the kernel to the plain version on the card. Skipped
where no g++ is installed."""

import ctypes
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_port_softmax_emulated as softmax_emu

from inductive_recommendation_tpu.data import sampling as jax_sampling
from inductive_recommendation_tpu_torch.data import sampling
from inductive_recommendation_tpu_torch.ops import _build

# the CUDA names this source uses beyond the shim's
EXTRA = r"""
constexpr cudaError_t cudaErrorInvalidValue = 1;
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA source")
    work = tmp_path_factory.mktemp("bpr_sample_emulated")
    (work / "cuda_shim.h").write_text(softmax_emu.SHIM + EXTRA)
    (work / "bpr_sample.cpp").write_text(softmax_emu._host_source((_build.CSRC / "bpr_sample.cu").read_text()))
    out = work / "libbpr_sample_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w", f"-I{work}", "-o", str(out),
                    str(work / "bpr_sample.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES["bpr_sample"]:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture
def emulated(lib, monkeypatch):
    """``sample_bpr_batch_cuda`` launching the emulated kernel on CPU tensors."""
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's device index
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=None))
    return sampling.sample_bpr_batch_cuda


def _train(n_users, n_items, seed):
    """Per-user train lists: power-law degrees with runs of users who hold
    nothing, duplicated items, degree-1 users, one user with the whole
    catalog and one with all but one item."""
    rng = np.random.default_rng(seed)
    degrees = np.minimum(rng.zipf(1.6, n_users), n_items // 2)
    degrees[rng.random(n_users) < 0.2] = 0
    degrees[3:6] = 1
    train = [list(rng.choice(n_items, size=d, replace=False)) for d in degrees]
    for u in range(0, n_users, 7):
        if train[u]:
            train[u] += train[u][: 1 + len(train[u]) // 2]  # duplicates, dropped at build
    train[1] = list(range(n_items))[::-1]
    train[2] = [i for i in range(n_items) if i != n_items // 3]
    return train


CASES = {
    # name: (n_users, n_items, batch, neg_ratio)
    "neg_ratio 1, two blocks": (300, 97, 512, 1),
    "neg_ratio 4, B not a multiple of the block": (300, 97, 333, 4),
    "B 1": (40, 33, 1, 1),
    "B 1, neg_ratio 4": (40, 33, 1, 4),
    "a catalog of one item": (5, 1, 65, 2),
    "wide catalog, B 2,048": (500, 5000, 2048, 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_draws_the_plain_batch(emulated, name):
    n_users, n_items, batch, neg_ratio = CASES[name]
    train = _train(n_users, n_items, len(name))
    state = sampling.build_sampler_state(train, n_items)
    gen = torch.Generator().manual_seed(2**31 + len(name))
    twin = torch.Generator().set_state(gen.get_state())
    before = sampling.sample_bpr_batch_cuda.launches
    got = emulated(state, gen, batch, neg_ratio)
    assert sampling.sample_bpr_batch_cuda.launches == before + 1
    want = sampling.sample_bpr_batch(state, twin, batch, neg_ratio)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == w.shape and torch.equal(g, w), name
    assert torch.equal(gen.get_state(), twin.get_state())

    users, pos, neg = (t.numpy() for t in got)
    own = [set(t) for t in train]
    assert all(own[u] for u in users), "a user with no train item was drawn"
    assert all(p in own[u] for u, p in zip(users, pos))
    for u, row in zip(users, neg):
        full = len(own[u]) == n_items
        assert all((n == n_items - 1) if full else (n not in own[u] and 0 <= n < n_items) for n in row)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_draws_the_jax_batch(emulated, monkeypatch, name):
    """The JAX package's draw handed the port's three draws, in its order:
    its split passes the key through and its randint returns the next draw,
    after checking that the shape and range it asks for are the port's."""
    n_users, n_items, batch, neg_ratio = CASES[name]
    train = _train(n_users, n_items, len(name))
    state = sampling.build_sampler_state(train, n_items)
    gen = torch.Generator().manual_seed(2**31 + 3 * len(name))
    twin = torch.Generator().set_state(gen.get_state())
    got = emulated(state, gen, batch, neg_ratio)

    highs = (state.valid_users.shape[0], 1 << 30, 1 << 30)
    draws = iter(zip(sampling._draws(state, twin, batch, neg_ratio), highs))

    def randint(key, shape, minval, maxval, *args, **kwargs):
        draw, high = next(draws)
        assert tuple(shape) == tuple(draw.shape) and (minval, maxval) == (0, high)
        return jnp.asarray(draw.numpy(), dtype=jnp.int32)

    monkeypatch.setattr(jax.random, "split", lambda key, num=2: (key,) * num)
    monkeypatch.setattr(jax.random, "randint", randint)
    want = jax_sampling.sample_bpr_batch(jax_sampling.build_sampler_state(train, n_items), jax.random.PRNGKey(0),
                                         batch, neg_ratio)
    assert next(draws, None) is None
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.numpy(), np.asarray(w).astype(np.int64)), name


def test_the_search_reaches_every_rank(emulated):
    """Every draw of the deepest search and of the whole catalog: a user at
    the largest degree gets each of its non-positive ids, the full user the
    clamped id, over a batch large enough to see them all."""
    n_items = 64
    positives = sorted(np.random.default_rng(0).choice(n_items, size=40, replace=False).tolist())
    train = [positives, [], [7], list(range(n_items))]
    state = sampling.build_sampler_state(train, n_items)
    assert state.max_degree == n_items
    gen = torch.Generator().manual_seed(5)
    twin = torch.Generator().set_state(gen.get_state())
    users, pos, neg = emulated(state, gen, 3000, 4)
    want = sampling.sample_bpr_batch(state, twin, 3000, 4)
    assert all(torch.equal(a, b) for a, b in zip((users, pos, neg), want))
    first = neg[users == 0].flatten().numpy()
    assert set(first) == set(range(n_items)) - set(positives)
    assert set(neg[users == 3].flatten().tolist()) == {n_items - 1}
    assert set(neg[users == 2].flatten().tolist()) == set(range(n_items)) - {7}
    assert set(users.tolist()) == {0, 2, 3}


def test_entry_refuses_and_skips(lib, emulated):
    state = sampling.build_sampler_state([[1, 2], [0]], 4)
    ud = pd = rd = torch.zeros(4, dtype=torch.int64)
    out = torch.full((12,), -7, dtype=torch.int64)
    ptrs = (ud.data_ptr(), pd.data_ptr(), rd.data_ptr(), out.data_ptr())
    assert lib.bpr_sample(*state.kernel_args, *ptrs, 4, 0, None) != 0  # no negative a pair
    assert lib.bpr_sample(*state.kernel_args, *ptrs, -1, 1, None) != 0
    assert lib.bpr_sample(*state.kernel_args, *ptrs, 0, 1, None) == 0
    assert torch.equal(out, torch.full((12,), -7, dtype=torch.int64))  # an empty batch writes nothing
    before = sampling.sample_bpr_batch_cuda.launches
    users, pos, neg = emulated(state, torch.Generator().manual_seed(0), 0, 3)
    assert users.shape == pos.shape == (0,) and neg.shape == (0, 3)
    assert sampling.sample_bpr_batch_cuda.launches == before
    with pytest.raises(ValueError, match="neg_ratio >= 1"):
        emulated(state, torch.Generator(), 8, 0)


def test_cpu_tensors_keep_the_plain_path_and_copies_resolve_their_own_pointers():
    import copy
    import pickle

    state = sampling.build_sampler_state([[1, 2, 2], [], [0]], 4)
    before = sampling.sample_bpr_batch_cuda.launches
    got = sampling.sample_bpr_batch(state, torch.Generator().manual_seed(3), 16, 2)
    want = sampling.sample_bpr_batch_reference(state, torch.Generator().manual_seed(3), 16, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sampling.sample_bpr_batch_cuda.launches == before
    for other in (copy.deepcopy(state), pickle.loads(pickle.dumps(state))):
        assert other.kernel_args[:4] == tuple(t.data_ptr() for t in (other.valid_users, other.items_flat,
                                                                      other.offsets, other.deg))
        assert other.kernel_args != state.kernel_args and other.kernel_args[4] == 4
    with pytest.raises(ValueError, match="contiguous int64"):
        sampling.SamplerState(state.items_flat, state.offsets, state.deg.int(), state.valid_users, 4, 2)
