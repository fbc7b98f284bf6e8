"""One run of one cell: the port's `Trainer.train_step`, driven back to
back from device-resident batches, then checked against the plain
reference.

1. Set-up: the port's kernel library is loaded (built in a checkout's
   first run); the cell's driver builds the port's `Trainer`; the
   weights are drawn from the seed on the device and loaded into its
   model; the traffic pool is made. Every shape of the pool is warmed
   up. The trainer is then put back to the seed's start in place (the
   weights and running statistics reloaded, the SGD momentum zeroed),
   and the next three steps of the pool, the checked steps, go through
   `train_step`; the readings that `check` compares are taken from the
   program's own state (the optimizer's momentum after one step, the
   model's tensors after three). The window goes on from there, with
   the same object.
2. The window: `--seconds` of steps with no synchronisation, ended by
   `torch.cuda.synchronize()`; or, with `--trace 1`, the mix's
   `trace_steps` steps under `torch.profiler` (CUDA activity only).
3. After the window: the peak memory is read, the program's state is
   freed, and the reference trains three steps from the same weights on
   the same batches.

Every step of a cell that runs the port's flash attention must launch
K1, delta, K2 and K3 as often as `launches_per_step` says (18 each for the
Transformer); a run that does not is not correct (`launches_off`).
"""
from __future__ import annotations

import gc
import math
import sys
import time
from collections import Counter

import torch

from . import check, counts, generator, peaks
from . import devtrace
from .reference import train as reference_train
from .spec import Cell, metric_reader
from .weights import make_weights

FIRST_STEPS = 3  # the steps the reference follows
WARM_STEPS = 2   # steps of each shape before the window
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "shockwave_tpu")


def forbidden_modules(names=None) -> list:
    """The top-level names in `FORBIDDEN` of the modules `names` (by
    default, those loaded), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.detach().double())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Launches:
    """The port's flash-attention launches, by kernel, against the count
    a step should make."""

    def __init__(self, per_step: dict):
        self.per_step = per_step
        self.steps = 0
        self.off = 0
        if per_step:
            from shockwave_tpu_torch.ops.flash_attention import LAUNCHES
            self._launches = LAUNCHES
        self.last = self.totals()

    def totals(self) -> dict:
        return {k: sum(v for name, v in self._launches.items() if name.startswith(k))
                for k in self.per_step}

    def count(self, steps: int) -> None:
        """Adds to `off` how far the launches since the last count are
        from `steps` steps' worth."""
        now = self.totals()
        self.off += sum(abs(now[k] - self.last[k] - steps * n) for k, n in self.per_step.items())
        self.last, self.steps = now, self.steps + steps


def _load_weights(trainer, spec, weights) -> None:
    state = {name: weights[name] for name, _, _, _ in spec}
    trainer.model.load_state_dict(state, strict=True)


def reset(trainer, spec, seed) -> None:
    """Puts `trainer` back to the seed's start, in place: the weights and
    running statistics reloaded, the SGD momentum zeroed (a zero buffer
    takes the next gradient whole, as a fresh one does)."""
    _load_weights(trainer, spec, make_weights(spec, seed, trainer.device))
    for state in trainer.optimizer.state.values():
        if state.get("momentum_buffer") is not None:
            state["momentum_buffer"].zero_()


def first_steps(trainer, batches, spec, seed, launches) -> dict:
    """The program's readings over `batches`, one step each from the
    seed's start (see `check`)."""
    model, device = trainer.model, trainer.device
    params = dict(model.named_parameters())
    trained = [name for name, _, _, train in spec if train]
    losses, grads = [], None
    for k, batch in enumerate(batches):
        metrics = trainer.train_step(*batch.tensors)
        launches.count(1)
        losses.append(metrics["loss"].detach().double())
        if k == 0:
            zero = torch.zeros((), dtype=torch.float64, device=device)
            state = trainer.optimizer.state
            grads = torch.stack([
                _norm(state[params[n]]["momentum_buffer"])
                if "momentum_buffer" in state.get(params[n], {}) else zero for n in trained])
    start = make_weights(spec, seed, device)
    now = model.state_dict()
    change = torch.stack([_norm(now[n].float() - start[n]) for n, _, _, _ in spec])
    del start
    return {"losses": torch.stack(losses).tolist(),
            "grad_norms": dict(zip(trained, grads.tolist())),
            "change_norms": dict(zip((n for n, _, _, _ in spec), change.tolist()))}


def warm_up(trainer, pool, launches) -> int:
    """Steps until every shape of the pool has run `WARM_STEPS` times;
    returns the pool index the checked steps start at."""
    seen = Counter()
    i = 0
    while any(seen[b.shape] < WARM_STEPS for b in pool):
        batch = pool[i % len(pool)]
        if seen[batch.shape] < WARM_STEPS:
            trainer.train_step(*batch.tensors)
            launches.count(1)
            seen[batch.shape] += 1
        i += 1
    return i


def timed_window(trainer, pool, i, seconds, launches):
    """(steps, work done, window seconds, last step's loss): steps until
    `seconds` have passed, at least one."""
    steps = work = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        batch = pool[i % len(pool)]
        metrics = trainer.train_step(*batch.tensors)
        work += batch.count
        steps, i = steps + 1, i + 1
        if time.perf_counter() >= deadline:
            break
    _sync(trainer.device)
    window = time.perf_counter() - t0
    launches.count(steps)
    return steps, work, window, metrics["loss"]


def traced_window(trainer, pool, i, n_steps, launches):
    """(the profiled batches, window seconds, trace summary, last loss)."""
    loss_fn, marks, spans = trainer._loss_fn, [], []

    def timed_loss(model, *batch):
        out = loss_fn(model, *batch)
        marks.append(time.time_ns())
        return out

    trainer._loss_fn = timed_loss
    batches = [pool[(i + k) % len(pool)] for k in range(n_steps)]
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _sync(trainer.device)
            t0, end = time.perf_counter(), time.time_ns()
            for batch in batches:
                begin = time.time_ns()
                spans.append((end, begin, "between_steps"))
                metrics = trainer.train_step(*batch.tensors)
                end = time.time_ns()
                spans += [(begin, marks[-1], "forward"), (marks[-1], end, "backward_optimizer")]
            _sync(trainer.device)
            window = time.perf_counter() - t0
            spans.append((end, time.time_ns(), "synchronize"))
    finally:
        trainer._loss_fn = loss_fn
    launches.count(n_steps)
    return batches, window, devtrace.summarize(prof, spans), metrics["loss"]


def reference_readings(cell: Cell, seed, batches, device, precision="float32") -> dict:
    """The reference's readings from the seed's weights over `batches`,
    with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = cell.driver.param_spec(cell.config)
    weights = make_weights(spec, seed, device)
    model = cell.driver.Reference(cell.config, precision)
    return reference_train.train(model, spec, weights, [b.tensors for b in batches],
                                 cell.config["optimizer"])


def _device(device, memory_peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": memory_peak, "nvidia_smi": peaks.nvidia_smi()}


def _layer_context(cell, device, batches, window, summary) -> dict:
    cfg, driver = cell.config, cell.driver
    name = torch.cuda.get_device_name(device)
    _, (bytes_s, flops_s) = peaks.peaks(name)
    calls = [c for b in batches for c in driver.attention_calls(cfg, b.lengths)]
    rates = (bytes_s, flops_s, peaks.exp_rate(
        torch.cuda.get_device_properties(device).multi_processor_count))
    group_s = summary["group_s"]
    return {"steps": len(batches), "window_s": window,
            "busy_s": summary["busy_s"], "group_s": group_s,
            "ms_per_step": lambda *groups: sum(group_s.get(g, 0.0) for g in groups)
            * 1e3 / len(batches),
            "model_flops": sum(driver.model_flops(cfg, b.lengths) for b in batches),
            "peak_flops": flops_s,
            "attn_least_s": counts.least_seconds(calls, rates) if calls else None}


def _metrics(entries, ctx, log) -> dict:
    """The metrics of `entries`; one whose reader finds nothing to read
    is left out of the line, and named on `log`."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(ctx)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run", file=log)
        else:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checked_steps(trainer, pool, spec, seed, launches):
    """(readings, the checked batches, the pool index the window starts
    at): every shape warmed up, the trainer put back to the seed's
    start, then the next `FIRST_STEPS` batches of the pool."""
    i = warm_up(trainer, pool, launches)
    reset(trainer, spec, seed)
    batches = [pool[(i + k) % len(pool)] for k in range(FIRST_STEPS)]
    return first_steps(trainer, batches, spec, seed, launches), batches, i + FIRST_STEPS


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, patch=None, log=sys.stderr) -> dict:
    """One run of `cell`; returns the result line's object. `patch`, if
    given, is applied to the built `Trainer` (the tests break the timed
    path with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases = {"imports": time.perf_counter() - t_start}

    def phase(name):
        _sync(dev)
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    cfg, mix, driver = cell.config, cell.mix, cell.driver
    per_step = driver.launches_per_step(cfg) if device == "cuda" else {}
    dev = torch.device(device)
    if per_step:
        from shockwave_tpu_torch.ops import _build
        _build.library()
    phase("cuda_and_kernel_library")
    trainer = driver.build_trainer(cfg, mix, device)
    dev = trainer.device
    phase("trainer")
    spec = driver.param_spec(cfg)
    _load_weights(trainer, spec, make_weights(spec, seed, dev))
    pool = generator.make(mix, cfg, seed, dev)
    phase("weights_and_traffic")
    if patch is not None:
        patch(trainer)
    launches = Launches(per_step)
    prog, checked, i = checked_steps(trainer, pool, spec, seed, launches)
    phase("warm_up_and_checked_steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    print(f"set-up seconds by phase: {phases}", file=log)

    if trace:
        batches, window, summary, last_loss = traced_window(
            trainer, pool, i, mix["trace_steps"], launches)
        steps, work = len(batches), sum(b.count for b in batches)
    else:
        steps, work, window, last_loss = timed_window(trainer, pool, i, seconds, launches)
    finite = math.isfinite(float(last_loss))
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del trainer, pool, last_loss
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, checked, dev)
    readings, where = check.compare(prog, ref)
    limits = dict(cell.limits["limits"])
    numbers = {k: readings[k] for k in limits}
    if launches.per_step:
        numbers["launches_off"], limits["launches_off"] = launches.off, 0
    correct = finite and check.verdict(numbers, limits)

    if trace:
        ctx = _layer_context(cell, dev, batches, window, summary)
        metrics = _metrics(cell.per_layer, ctx, log)
    else:
        ctx = {"setup_s": setup_s, "window_s": window, "work": work}
        metrics = _metrics(cell.end_to_end, ctx, log)
    result = {"correct": correct, "attempted": steps, "failed": 0 if finite else steps,
              "metrics": metrics, "device": _device(dev, memory_peak)}
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=window)
        result["breakdown"] = summary["breakdown"]
        print(f"device seconds by kernel group: {summary['group_s']}", file=log)
    print(f"readings: {readings}; where: {where}; first losses program {prog['losses']} "
          f"reference {ref['losses']}", file=log)
    result["setup_phases_s"] = phases
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return result
