"""Traffic kind ``train``: the trainer's epochs back to back, closed loop,
one job (``train_one_epoch``: every step draws its batches on the device
and steps Adam, and the epoch ends with the model's epoch end, such as
IGCN's anneal and DOSE's selection and view rebuild).

Set-up builds one trainer, puts the benchmark's weights in it, drives its
first ``checked_steps`` steps through ``trainer.step`` (the call the epochs
make, on batches the trainer draws itself) and keeps what the check needs,
then warms up: an epoch of ``warmup_steps`` steps with its epoch end, whose
batches are kept as well and whose outputs the model's module keeps
(``first_epoch_end``), and ``warmup_steps`` more steps. The window runs
``train_one_epoch`` until the time is up; the step wrapper stops it at a
step boundary.

The check (``judge``): the reference follows every kept step from the same
weights, batches and dropout seeds; the checked steps' losses, first
gradient and parameter change are compared, and the model's module judges
the epoch end (the first one from the reference's own parameters after the
steps it followed, and what the window's epoch ends left). What is
particular to the model (its objective, its batches' contract, its epoch
end, its layouts and work) comes from its module, ``run.bench``."""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.core import data as bench_data
from port_bench.core import judge as J
from port_bench.core import port
from port_bench.core import reference as ref
from port_bench.core.timing import Trace, profiled


def setup(run):
    cfg, tr = run.config, run.traffic
    run.data = bench_data.synthetic(*cfg["data"]["sizes"], bench_data.seed_words(run.seed, 1))
    ds = port.dataset(run.data)
    model = port.build_model(cfg, ds, run.device)
    run.trainer_seed = int(bench_data.seed_words(run.seed, 2).generate_state(1)[0])
    trainer = port.build_trainer(cfg, ds, model, run.trainer_seed)
    run.weights0 = run.make_weights({k: tuple(v.shape) for k, v in trainer.params.items()})
    port.load_weights(trainer.params, run.weights0)
    run.model, run.trainer = model, trainer
    run.probe.wrap_trainer(trainer, run.bench.EPOCH_END)

    batches, draw = [], trainer.sample

    def recorded():
        batch = draw()
        batches.append(batch)
        return batch

    trainer.sample = recorded
    run.prog_losses, run.prog_m1 = [], None
    for i in range(tr["checked_steps"]):
        run.prog_losses.append(float(trainer.step()))
        if i == 0:  # the first moment as Adam holds it (zero where it holds none)
            state = trainer.optimizer.state
            run.prog_m1 = {k: state[p]["exp_avg"].detach().clone() if "exp_avg" in state.get(p, {})
                           else torch.zeros_like(p) for k, p in trainer.params.items()}
    run.prog_params = {k: p.detach().clone() for k, p in trainer.params.items()}

    # warm-up: an epoch and its end (its batches kept, its outputs judged),
    # then steps on what it left
    steps = trainer.steps_per_epoch
    trainer.steps_per_epoch = tr["warmup_steps"]
    trainer.train_one_epoch()
    trainer.steps_per_epoch = steps
    run.first_end = run.bench.first_epoch_end(run)
    del trainer.sample
    run.batches = [tuple(t.detach().cpu() for t in b) for b in batches]
    for _ in range(tr["warmup_steps"]):
        trainer.step()


def window(run, seconds):
    probe, trainer = run.probe, run.trainer
    probe.step_marks, probe.step_host_ms, probe.epoch_end_ms, probe.steps_done = [], [], [], 0
    run.sync()
    t0 = time.perf_counter()
    probe.open_window(seconds)
    try:
        while True:
            trainer.train_one_epoch()
    except port.WindowClosed:
        pass
    run.sync()
    run.window_s = time.perf_counter() - t0
    probe.close_window()
    run.units = probe.steps_done
    batch = run.config["trainer"]["batch_size"]
    intervals = probe.step_intervals_ms()
    return {
        "train_examples_per_s": batch * run.units / run.window_s,
        "step_p95_ms": float(np.percentile(intervals, 95)) if intervals else None,
    }


def profile(run) -> Trace:
    """``trace_steps`` steps and an epoch end under the profiler."""
    trainer = run.trainer
    steps = trainer.steps_per_epoch
    trainer.steps_per_epoch = run.traffic["trace_steps"]
    before = port.route_launches()
    try:
        _, dev, host, wall = profiled(trainer.train_one_epoch, run.device)
    finally:
        trainer.steps_per_epoch = steps
    return Trace(dev, host, wall, run.traffic["trace_steps"], port.launches_since(before))


def capture(run) -> dict:
    """Copies out of the program what the check reads, so that its state
    can be freed before the reference runs."""
    return {"losses": run.prog_losses, "m1": run.prog_m1, "params": run.prog_params,
            **run.bench.capture_train(run), **run.first_end}


def _followed(run, spec, dtype):
    """The reference over every kept batch: (losses, first gradients, the
    parameters after the checked steps, the parameters after all)."""
    batches = [tuple(t.to(run.device) for t in b) for b in run.batches]
    weights = {k: v.to(run.device) for k, v in run.weights0.items()}
    bench = run.bench
    return ref.follow_steps(lambda params, batch, seeds: bench.loss(spec, params, batch, seeds), weights, batches,
                            run.trainer_seed, run.config["trainer"]["lr"], dtype=dtype,
                            keep_after=run.traffic["checked_steps"])


def control_outputs(run, cap: dict, dtype=torch.bfloat16) -> dict:
    """The control: the reference in bfloat16 (the step below the float32
    the configuration states for the table, the SpMM products and the
    steps), put in the program's place: its losses, first moments and
    parameters, and its epoch end, in the shapes ``capture`` gives the
    program's."""
    spec = run.bench.cast_spec(run.bench.train_spec(run), dtype)
    losses, g1, params, params_end = _followed(run, spec, dtype)
    out = dict(cap, losses=losses[: run.traffic["checked_steps"]], m1={k: 0.1 * g for k, g in g1.items()},
               params=params)
    out.update(run.bench.epoch_end_control(run, cap, spec, params_end, dtype))
    return out


def judge(run, out: dict) -> dict:
    """The numbers compared: the checked steps (losses, the first
    gradient's norm as Adam's first moment holds it, the parameters'
    change), the drawn batches, and the model's epoch end, each against the
    reference in float64."""
    spec = run.bench.train_spec(run)
    ref_losses, ref_g1, ref_p3, ref_end = _followed(run, spec, torch.float64)
    g1 = {k: v.to(torch.float64) / (1.0 - 0.9) for k, v in out["m1"].items()}
    p0 = {k: v.to(run.device, torch.float64) for k, v in run.weights0.items()}
    change = {k: out["params"][k].to(run.device, torch.float64) - p0[k] for k in p0}
    change_ref = {k: ref_p3[k] - p0[k] for k in p0}
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref_losses)),
        "grad_gap": J.leaf_gap({k: v.to(run.device) for k, v in g1.items()}, ref_g1),
        "change_gap": J.leaf_gap(change, change_ref, skip=J.negligible_leaves(ref_g1)),
        "batch_bad": float(run.bench.bad_triples(run.data, run.batches)),
    }
    numbers.update(run.bench.epoch_end_numbers(run, out, spec, ref_end))
    return numbers
