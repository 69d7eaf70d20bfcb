"""The single-device training step replayed as one CUDA graph.

On one card a training step launches the same kernels on the same shapes
every step, and between two epoch ends it reads the same layouts; run
eagerly, the host's 160-290 launches a step (each a Python wrapper or an
autograd node) set its pace. :class:`StepGraph` captures the forward and
the backward once and replays them:

- outside the graph, every step: the batch (the trainer's ``sample``, drawn
  on the card) is copied into the graph's input buffers, and the step's
  dropout seeds are drawn from the trainer's host generator, in the order
  and number the eager forward draws them, and copied to the graph's seed
  table in one asynchronous copy from pinned memory (a ring of buffers, so
  that the host never rewrites seeds a pending copy still reads); then the
  replay, the optimizer's step on the gradients the replay left, and a
  copy of the loss, which the next replay overwrites. The optimizer stays
  out of the graph: a captured Adam keeps its step count on the card and
  its bias corrections in fp32, where 1 - 0.999 loses five digits (an
  update 6.4e-6 off float64's against 1e-8 eager), and its seven launches
  a step cost the host less than the device's work;
- after the graph is made or dropped, the first step runs eagerly on a side
  stream (the warm-up torch asks for before a capture; it also fills the
  per-layout caches, such as the attention's chunk table, outside the
  graph's memory), the second is captured and replayed at once (a capture
  runs nothing), and every later one is replayed;
- the graph holds only while every tensor it reads is the one it captured:
  the trainer drops it at the start and the end of every epoch, at a
  dataset rebind, a parameter or optimizer state load and a new optimizer,
  and a step drops it when the model has rebound an attribute (a layout, a
  view) since the capture. A drop frees the graph and the gradients it
  made before the next capture, so that two graphs' memory never coexists;
- the launch counters that a step's kernels advance
  (``spmm_csr_cuda.launches`` and ``.route_launches``,
  ``attention_csr.route_launches``) count the kernels that ran: a capture's
  growth is taken back, and every replay adds it again. The sampler runs
  outside the graph and counts itself.

The captured products read their dropout seeds by address
(``ops.csr_spmm.SeedTable``). A trainer makes a ``StepGraph`` where
:func:`replays` says so.
"""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops import attention_csr
from inductive_recommendation_tpu_torch.ops.csr_spmm import SeedTable, dropout_seed, spmm_csr_cuda
from inductive_recommendation_tpu_torch.utils.profiling import span

MAX_SEEDS = 16  # the dropout seeds a captured step may draw
RING = 8  # pinned seed buffers, used in turn


def replays(model, device, mesh) -> bool:
    """Whether a trainer replays its step as a CUDA graph: on a CUDA device,
    with no mesh, for a model whose ``graph_step`` is True."""
    return mesh is None and torch.device(device).type == "cuda" and model.graph_step


def launch_counts() -> dict:
    """The launch counters a step's kernels advance, by name: the SpMM's
    total (``spmm_csr``), its routes (``spmm_csr/<route>``) and the
    attention kernels' (``attention_csr/<kernel>/<route>``)."""
    return {
        "spmm_csr": spmm_csr_cuda.launches,
        **{f"spmm_csr/{r}": n for r, n in spmm_csr_cuda.route_launches.items()},
        **{f"attention_csr/{k}": n for k, n in attention_csr.route_launches.items()},
    }


def add_launch_counts(counts: dict, sign: int = 1):
    """Adds ``sign`` times ``counts`` (named as :func:`launch_counts` names
    them) to the counters."""
    for name, n in counts.items():
        kind, _, key = name.partition("/")
        if not key:
            spmm_csr_cuda.launches += sign * n
        elif kind == "spmm_csr":
            spmm_csr_cuda.route_launches[key] += sign * n
        else:
            attention_csr.route_launches[key] = attention_csr.route_launches.get(key, 0) + sign * n


def _warm_up(fn, stream):
    """``fn()`` on ``stream``, after the current stream's work and before
    what the current stream does next."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    return out


def _capture(fn, stream):
    """(graph, ``fn()``): the kernels ``fn`` launches captured on ``stream``
    into a new CUDA graph, whose memory is its own; none of them runs."""
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, out


class StepGraph:
    """A trainer's step as a replayed CUDA graph (the module's docstring).
    ``step(batch)`` runs one step on a sampled batch and returns its loss."""

    def __init__(self, trainer):
        self.trainer = trainer
        cuda = trainer.device.type == "cuda"
        self.stream = torch.cuda.Stream(trainer.device) if cuda else None
        self.seeds = SeedTable(MAX_SEEDS, trainer.device)
        self._host = [torch.zeros(MAX_SEEDS, dtype=torch.int64, pin_memory=cuda) for _ in range(RING)]
        self._copied = [None] * RING  # an event after the last copy from each buffer
        self._turn = 0
        self.graph = None
        self.warm = False  # an eager step ran since the last drop
        self.batch = self.loss = self._read = None
        self.n_seeds = 0
        self.growth = {}

    def drop(self):
        """Frees the graph and the gradients it made; the next step runs
        eagerly."""
        if self.graph is not None:
            self.trainer.optimizer.zero_grad(set_to_none=True)
        self.graph = self.batch = self.loss = self._read = None
        self.warm = False

    def _reads(self) -> list:
        """What a captured step holds by address: the model's attributes (its
        layouts and views among them)."""
        return list(vars(self.trainer.model).values())

    def _current(self) -> bool:
        now = self._reads()
        return len(now) == len(self._read) and all(a is b for a, b in zip(now, self._read))

    def step(self, batch) -> torch.Tensor:
        if self.graph is not None and not self._current():
            self.drop()
        if not self.warm:
            self.warm = True
            return _warm_up(lambda: self.trainer.eager_step(batch), self.stream)
        if self.graph is None:
            self._capture(batch)
        loss = self._replay(batch)
        self.trainer.optimizer_step()
        return loss

    def _capture(self, batch):
        trainer = self.trainer
        self.batch = tuple(t.clone() for t in batch)
        # the backward makes the gradients in the graph's memory
        trainer.optimizer.zero_grad(set_to_none=True)
        before = launch_counts()
        with span("irt.train.capture"):
            self.graph, self.loss = _capture(self._forward_backward, self.stream)
        self.n_seeds = self.seeds.taken
        after = launch_counts()
        self.growth = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        add_launch_counts(self.growth, -1)
        self._read = self._reads()

    def _forward_backward(self) -> torch.Tensor:
        """The forward and backward on the graph's batch, the forward's
        dropout seeds the seed table's entries."""
        trainer = self.trainer
        generator, trainer.host_generator = trainer.host_generator, self.seeds
        self.seeds.taken = 0
        try:
            return trainer.forward_backward(self.batch)
        finally:
            trainer.host_generator = generator

    def _replay(self, batch) -> torch.Tensor:
        with span("irt.train.replay"):
            for static, t in zip(self.batch, batch):
                static.copy_(t)
            if self.n_seeds:
                self._copy_seeds([dropout_seed(self.trainer.host_generator) for _ in range(self.n_seeds)])
            self.graph.replay()
            add_launch_counts(self.growth)
            return self.loss.clone()

    def _copy_seeds(self, seeds):
        """``seeds`` into the seed table: one copy from the next pinned
        buffer, once the copy that last read it has run."""
        i, n = self._turn % RING, len(seeds)
        self._turn += 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        host = self._host[i]
        host[:n] = torch.tensor(seeds, dtype=torch.int64)
        self.seeds.values[:n].copy_(host[:n], non_blocking=True)
        if self.seeds.values.is_cuda:
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record()
