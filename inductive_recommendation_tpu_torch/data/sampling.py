"""BPR negative sampling on the device (counterpart of
``inductive_recommendation_tpu/data/sampling.py``).

The reference samples on the host in DataLoader workers (dataset.py:119-131):
a uniform user with at least one train item, a uniform positive of that
user, and rejection-sampled negatives. Here a batch is drawn on the model's
device from an explicit ``torch.Generator`` there: three ``torch.randint``
draws, then, for CUDA tensors, one launch of the hand-written kernel of
``ops/csrc/bpr_sample.cu`` (``sample_bpr_batch_cuda`` counts them in
``sample_bpr_batch_cuda.launches``), and for CPU tensors the plain PyTorch
version, ``sample_bpr_batch_reference``. Both map the same draws to the same
batch, bit for bit.

Layout: each user's train items, deduplicated and sorted, one slice per user
of ``items_flat`` (``offsets``/``deg``), O(|E|) memory.

Negatives are exact (no rejection): a rank r is drawn uniformly over the
user's non-positive items and mapped to the item x with r non-positives
before it (x - #{positives < x} == r) by a binary search over the user's
sorted positives. This is the distribution the reference's rejection loop
converges to, with no false negatives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from inductive_recommendation_tpu_torch.ops import _build


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """The sampler's tensors on one device.

    valid_users: users with deg > 0; the reference resamples until it draws
    one (dataset.py:120-122), and a uniform choice among them is the closed
    form of that loop."""

    items_flat: torch.Tensor  # int64 [E], each user's slice sorted, no duplicates
    offsets: torch.Tensor  # int64 [n_users + 1]
    deg: torch.Tensor  # int64 [n_users]
    valid_users: torch.Tensor  # int64 [n_valid]
    n_items: int
    max_degree: int
    # the kernel's operands, resolved once: the draw runs twice a training step
    kernel_args: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        tensors = (self.valid_users, self.items_flat, self.offsets, self.deg)
        if any(t.dtype != torch.int64 or not t.is_contiguous() or t.device != self.deg.device for t in tensors):
            raise ValueError("the sampler's tensors must be contiguous int64 on one device")
        object.__setattr__(self, "kernel_args", (*(t.data_ptr() for t in tensors), self.n_items))

    def __reduce__(self):
        # a copy resolves its own tensors' pointers
        return type(self), tuple(getattr(self, f.name) for f in dataclasses.fields(self) if f.init)


def build_sampler_state(train_data, n_items, device="cpu") -> SamplerState:
    """From per-user train item lists. Duplicated items are dropped: the
    complement rank map needs strictly increasing positives."""
    lengths = np.fromiter((len(t) for t in train_data), dtype=np.int64, count=len(train_data))
    if lengths.sum() == 0:
        raise ValueError("no user has a train item: there is nothing to sample")
    users = np.repeat(np.arange(len(train_data), dtype=np.int64), lengths)
    items = np.concatenate([np.asarray(t, np.int64) for t in train_data if len(t)])
    keys = np.unique(users * max(n_items, 1) + items)  # sorted by user, then item
    users, items = keys // max(n_items, 1), keys % max(n_items, 1)
    deg = np.bincount(users, minlength=len(train_data))
    offsets = np.concatenate([[0], np.cumsum(deg)])

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=device)

    return SamplerState(
        items_flat=put(items),
        offsets=put(offsets),
        deg=put(deg),
        valid_users=put(np.nonzero(deg > 0)[0]),
        n_items=int(n_items),
        max_degree=int(deg.max()),
    )


def sample_bpr_batch(state: SamplerState, generator: torch.Generator, batch_size: int, neg_ratio: int = 1):
    """Draw (users [B], pos_items [B], neg_items [B, neg_ratio]), int64, on
    the state's device; ``generator`` must live there too.

    Users are uniform over users with a train item, the positive uniform over
    the user's train items (shared by its neg_ratio negatives), the negatives
    uniform over the user's non-positive items. A user who holds the whole
    catalog has no negative: its ids are clamped to the last item, as the
    JAX package does. CUDA tensors take the kernel, others the plain
    version; both consume the generator alike and give the same bits."""
    if state.deg.is_cuda:
        return sample_bpr_batch_cuda(state, generator, batch_size, neg_ratio)
    return sample_bpr_batch_reference(state, generator, batch_size, neg_ratio)


def _draws(state, generator, batch_size, neg_ratio):
    """The batch's three uniform draws, in this order: the users' indices
    into ``valid_users``, the positives' slots and the negatives' ranks
    (each taken modulo the user's count)."""
    dev = state.deg.device
    return (
        torch.randint(0, state.valid_users.shape[0], (batch_size,), generator=generator, device=dev),
        torch.randint(0, 1 << 30, (batch_size,), generator=generator, device=dev),
        torch.randint(0, 1 << 30, (batch_size * neg_ratio,), generator=generator, device=dev),
    )


def sample_bpr_batch_reference(state: SamplerState, generator: torch.Generator, batch_size: int, neg_ratio: int = 1):
    """Plain PyTorch version of :func:`sample_bpr_batch`, on any device."""
    ud, pd, rd = _draws(state, generator, batch_size, neg_ratio)
    users = state.valid_users[ud]
    pos_slot = pd % state.deg[users]
    pos_items = state.items_flat[state.offsets[users] + pos_slot]

    flat_users = users.repeat_interleave(neg_ratio)
    deg = state.deg[flat_users]
    off = state.offsets[flat_users]
    r = rd % torch.clamp(state.n_items - deg, min=1)
    # the first j in [0, deg] with P[j] - j > r: the invariant is
    # P[j] - j <= r below lo, and a fixed number of steps covers any degree
    last = state.items_flat.shape[0] - 1
    lo, hi = torch.zeros_like(deg), deg
    for _ in range(int(np.ceil(np.log2(max(2, state.max_degree)))) + 1):
        mid = (lo + hi) // 2
        p_mid = state.items_flat[torch.clamp(off + mid, 0, last)]
        # mid < hi: once lo == hi, mid points one past the user's slice (the
        # next user's items) and must not move lo
        go_right = (p_mid - mid <= r) & (mid < hi)
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    neg = torch.clamp(r + torch.minimum(lo, deg), max=state.n_items - 1)
    return users, pos_items, neg.view(batch_size, neg_ratio)


def sample_bpr_batch_cuda(state: SamplerState, generator: torch.Generator, batch_size: int, neg_ratio: int = 1):
    """The same draws, mapped to the batch by one launch of
    ``csrc/bpr_sample.cu`` on the current stream (no synchronisation).
    The three outputs are views of one fresh int64 buffer. Counts one launch
    a draw of at least one pair in ``sample_bpr_batch_cuda.launches``."""
    if neg_ratio < 1 or batch_size < 0 or batch_size * neg_ratio >= 2**31:
        raise ValueError(f"the kernel takes batch_size >= 0, neg_ratio >= 1 and int32 sizes; got {batch_size}, "
                         f"{neg_ratio}")
    ud, pd, rd = _draws(state, generator, batch_size, neg_ratio)
    dev = state.deg.device
    out = torch.empty(batch_size * (2 + neg_ratio), dtype=torch.int64, device=dev)
    fn = _build.load("bpr_sample").bpr_sample
    args = (*state.kernel_args, ud.data_ptr(), pd.data_ptr(), rd.data_ptr(), out.data_ptr(), batch_size, neg_ratio,
            torch.cuda.current_stream(dev).cuda_stream)
    # entering torch.cuda.device costs 4.9-6.3 us of a draw's 95-147 us of host enqueue on an H100 machine
    # (chip_smoke.sampler_phase), so a state on the current card launches without it
    if torch.cuda.current_device() == dev.index:
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"bpr_sample kernel launch failed: cudaError {err}")
    sample_bpr_batch_cuda.launches += batch_size > 0
    return out[:batch_size], out[batch_size : 2 * batch_size], out[2 * batch_size :].view(batch_size, neg_ratio)


sample_bpr_batch_cuda.launches = 0
