#!/usr/bin/env python3
"""Throughput profiler: measure isolated steps/sec per (job_type, sf).

The port of the JAX package's `scripts/profiling/measure_throughput.py`,
with its CLI and its output: the throughput-oracle JSON the scheduler
reads (`core/oracle.py`), keyed `str((oracle_job_type(family, bs), sf))`
with the isolated rate under "null".

    python -m shockwave_tpu_torch.profiling.measure_throughput \\
        --output data/h100_throughputs.json [--families LM ResNet-18] \\
        [--only LM:80] [--steps 30] [--device cpu]

Each row builds the trainer of its family's trace command
(`core/job_table.py`) at the row's batch size through the family main's
`build_trainer` (A3C's and CycleGAN's `build_job`), and times its
`train_step` on one batch with two-point marginal timing
(`core/timing.py`); an A3C step is one update (a 20-step unroll and one
Adam step over `--workers` environments, the row's batch size), a
CycleGAN step updates both generators and both discriminators. The rate
is the rate of the job the scheduler dispatches: on the card the
Transformer runs the CUDA flash kernels, as its main turns them on (the
JAX package's profiler builds its Transformer with flash off, while its
trainer runs flash). The oracle's `__meta__.throughput_detail[worker_type]`
records the card, its `nvidia-smi` name and power limit, and the torch
version.

Runs on the CUDA card unless `--device cpu` is given (one device). A3C
and CycleGAN are one-card families: their sf > 1 rows are skipped, as in
the reference. `--trace_out` writes one `profile-measure` span per
row as Chrome-trace JSON, and each row's wall time goes into the
`swtpu_profile_measure_seconds` histogram, as in the reference. Not
ported, and refused rather than skipped: a scale factor above 1 that
the device count allows (a gang's rate is measured across as many cards,
item 12); one above the device count is skipped, as in the reference.
The committed h100 file's sf > 1 rows are `extrapolate_sf.py`'s priors.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import itertools
import json
import os
import platform
import shlex
import sys
import tempfile

import torch

from ..core import job_table
from ..core.constants import DEFAULT_BS, oracle_job_type
from ..core.timing import marginal_step_time
from ..models.train_common import upload
from ..obs import Observability
from ..obs import names as obs_names
from ..obs.clock import perf_clock

# (family -> profiled batch sizes) mirrors the job template table.
FAMILY_BATCH_SIZES = {
    "ResNet-18": [16, 32, 64, 128, 256],
    "ResNet-50": [16, 32, 64, 128],
    "Transformer": [16, 32, 64, 128],
    "LM": [5, 10, 20, 40, 80],
    "Recommendation": [512, 1024, 2048, 4096, 8192],
    "A3C": [4],
    "CycleGAN": [1],
}

# Family -> its job template (the trace's command at a batch size; A3C's
# batch is its number of environments, `--workers`).
TEMPLATES = {"ResNet-18": job_table.resnet18, "ResNet-50": job_table.resnet50,
             "Transformer": job_table.transformer, "LM": job_table.lm,
             "Recommendation": job_table.recommendation,
             "A3C": lambda bs: _with_flag(job_table.a3c(), f"--workers {bs}"),
             "CycleGAN": lambda bs: _with_flag(job_table.cyclegan(), f"--batch_size {bs}")}
# The data root the trace's %s stands for; absent datasets fall back to
# the loaders' synthetic batches (as in measure_startup.py).
DATA_DIR = os.path.join(tempfile.gettempdir(), "swtpu_data")

GANG_ITEM = ("ROADMAP.md Queue 1, item 12 (sf > 1 oracle rows and the NCCL path "
             "on a machine with more than one card)")


def _with_flag(template, flag: str):
    """`template` with `flag` appended to its command (the last value of
    a flag wins)."""
    return dataclasses.replace(template, command=f"{template.command} {flag}")


def build_family(model_name: str, bs: int, device: str = "cuda"):
    """(trainer, step_fn, batch): the trainer of the family's trace
    command at batch size `bs`, built by its main's `build_trainer` (or
    `build_job`) on `device`; `step_fn(trainer, batch) -> (trainer,
    loss)` over its `train_step`; and one batch on the device (A3C's is
    empty)."""
    template = TEMPLATES[model_name](bs)
    # "python3 <script>.py <cli>" under workloads/<working_directory>.
    command = template.command % (DATA_DIR,) if "%s" in template.command else template.command
    script, *cli = shlex.split(command)[1:]
    module = ".".join(template.working_directory.split("/") + [script[:-len(".py")]])
    main = importlib.import_module(f"shockwave_tpu_torch.workloads.{module}")
    if hasattr(main, "build_job"):
        trainer, loader, _ = main.build_job(cli + ["--device", device])
    else:
        trainer = main.build_trainer(cli + ["--device", device])
        loader = trainer.data_loader
    batch = tuple(upload(b, trainer.device) for b in next(iter(loader)))

    def step(trainer, batch):
        return trainer, trainer.train_step(*batch)["loss"]

    return trainer, step, batch


def device_count(device: str) -> int:
    return torch.cuda.device_count() if device == "cuda" else 1


def measure(model_name: str, bs: int, sf: int, steps: int, warmup: int,
            device: str = "cuda"):
    """steps/sec for one (family, batch size, scale factor) combination,
    or None when fewer devices than `sf` are attached."""
    if sf > device_count(device):
        return None
    if sf > 1:
        raise NotImplementedError(
            f"scale factor {sf} is a gang across {sf} cards, whose rate this "
            f"profiler does not measure yet: {GANG_ITEM}")
    state, step_fn, batch = build_family(model_name, bs, device)
    dt = marginal_step_time(step_fn, state, batch,
                            n1=max(steps // 4, 2), n2=steps, warmup=warmup)
    return 1.0 / dt


def measure_pair(fam_a, bs_a, fam_b, bs_b, steps, warmup, dt_cache=None,
                 device: str = "cuda"):
    """Packed-pair steps/s: both jobs co-resident on one device.

    Co-located jobs time-share the device: the pair rate is round-robin
    time-slicing with a step ratio k_a:k_b chosen from the isolated step
    times so each job gets about equal device time, as in the reference.
    Returns (rate_a, rate_b, dt_a, dt_b) — pair rates plus the isolated
    marginal step times measured along the way."""
    state_a, step_a, batch_a = build_family(fam_a, bs_a, device)
    state_b, step_b, batch_b = build_family(fam_b, bs_b, device)
    n1 = max(steps // 4, 2)
    # Isolated marginal step times are per-row quantities; cache them so a
    # --packed grid of n rows measures n of them, not n^2.
    if dt_cache is None:
        dt_cache = {}
    if (fam_a, bs_a) not in dt_cache:
        dt_cache[(fam_a, bs_a)] = marginal_step_time(
            step_a, state_a, batch_a, n1=n1, n2=steps, warmup=warmup)
    if (fam_b, bs_b) not in dt_cache:
        dt_cache[(fam_b, bs_b)] = marginal_step_time(
            step_b, state_b, batch_b, n1=n1, n2=steps, warmup=warmup)
    dt_a, dt_b = dt_cache[(fam_a, bs_a)], dt_cache[(fam_b, bs_b)]
    if dt_a <= dt_b:
        k_a, k_b = max(1, round(dt_b / dt_a)), 1
    else:
        k_a, k_b = 1, max(1, round(dt_a / dt_b))

    def quantum(state, _):
        sa, sb = state
        la = lb = None
        for _ in range(k_a):
            sa, la = step_a(sa, batch_a)
        for _ in range(k_b):
            sb, lb = step_b(sb, batch_b)
        # Sum the two losses so the closing fetch waits for BOTH chains.
        loss = la.float().reshape(-1)[0] + lb.float().reshape(-1)[0]
        return (sa, sb), loss

    dt_q = marginal_step_time(quantum, (state_a, state_b), None,
                              n1=2, n2=8, warmup=max(1, warmup // 2))
    return k_a / dt_q, k_b / dt_q, dt_a, dt_b


def provenance(device: str, steps: int, warmup: int, rows) -> dict:
    """What the rates were measured on, for the oracle's __meta__."""
    on_card = device == "cuda"
    smi = None
    if on_card:
        from .device import nvidia_smi
        smi = nvidia_smi()
    return {
        "measured_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "host": platform.node(),
        "method": ("two-point marginal time of train_step on one batch "
                   "(core/timing.py), built by the family main's "
                   "build_trainer (A3C's and CycleGAN's build_job) at the "
                   "row's batch size"),
        # What this run measured (FAMILY:BS): with --merge, the file's
        # other rows keep the rates an earlier run wrote.
        "rows": rows,
        "steps": steps,
        "warmup": warmup,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worker_type", default="h100")
    p.add_argument("--output", required=True)
    p.add_argument("--families", nargs="*", default=list(TEMPLATES))
    p.add_argument("--only", nargs="*", default=None, metavar="FAMILY:BS",
                   help="profile exactly these family:batch_size rows "
                        "(e.g. ResNet-18:32 LM:20), overriding --families")
    p.add_argument("--scale_factors", nargs="*", type=int, default=[1, 2, 4, 8])
    p.add_argument("--packed", action="store_true",
                   help="also measure every unordered pair (including "
                        "self-pairs) of the resolved rows co-resident on "
                        "one device (sf=1 only)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--merge", action="store_true",
                   help="merge into an existing oracle file")
    p.add_argument("--trace_out", default=None, metavar="TRACE_JSON",
                   help="export one span per profiled row as Chrome-trace "
                        "JSON — the profiling session's timeline")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to measure (default: the CUDA card)")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass --device cpu "
                           "to profile on the CPU")

    if args.only:
        rows = []
        for spec in args.only:
            family, sep, bs = spec.rpartition(":")
            if not sep or family not in FAMILY_BATCH_SIZES \
                    or not bs.isdigit():
                p.error(f"--only expects FAMILY:BS with FAMILY one of "
                        f"{sorted(FAMILY_BATCH_SIZES)}; got {spec!r}")
            rows.append((family, int(bs)))
    else:
        unknown = sorted(set(args.families) - set(FAMILY_BATCH_SIZES))
        if unknown:
            p.error(f"unknown families {unknown}; known: {sorted(FAMILY_BATCH_SIZES)}")
        rows = [(family, bs) for family in args.families
                for bs in FAMILY_BATCH_SIZES[family]]
    # Per-row wall time rides the obs pipeline (spans + the
    # swtpu_profile_measure_seconds histogram); the device timing itself
    # stays core/timing.marginal_step_time.
    obs = Observability(clock=perf_clock, enabled=True)

    oracle = {}
    if args.merge and os.path.exists(args.output):
        with open(args.output) as f:
            oracle = json.load(f)
    table = oracle.setdefault(args.worker_type, {})

    n_devices = device_count(args.device)
    for family, bs in rows:
        for sf in args.scale_factors:
            if sf > n_devices:
                print(f"skip {family} bs={bs} sf={sf}: "
                      f"only {n_devices} devices", file=sys.stderr)
                continue
            if family in DEFAULT_BS and sf > 1:
                continue  # A3C / CycleGAN are single-chip families
            with obs.span(obs_names.SPAN_PROFILE_MEASURE, family=family,
                          bs=bs, sf=sf), \
                    obs.timed(obs_names.PROFILE_MEASURE_SECONDS,
                              family=family):
                tput = measure(family, bs, sf, args.steps, args.warmup, args.device)
            key = str((oracle_job_type(family, bs), sf))
            table.setdefault(key, {})["null"] = round(tput, 4)
            print(f"{args.worker_type} {key}: {tput:.3f} steps/s", flush=True)

    if args.packed:
        dt_cache = {}
        for (fam_a, bs_a), (fam_b, bs_b) in \
                itertools.combinations_with_replacement(rows, 2):
            with obs.span(obs_names.SPAN_PROFILE_MEASURE,
                          family=f"{fam_a}+{fam_b}", bs=[bs_a, bs_b],
                          sf=1), \
                    obs.timed(obs_names.PROFILE_MEASURE_SECONDS,
                              family=f"{fam_a}+{fam_b}"):
                rate_a, rate_b, _, _ = measure_pair(
                    fam_a, bs_a, fam_b, bs_b, args.steps, args.warmup,
                    dt_cache=dt_cache, device=args.device)
            key_a = str((oracle_job_type(fam_a, bs_a), 1))
            key_b = str((oracle_job_type(fam_b, bs_b), 1))
            table.setdefault(key_a, {})[key_b] = [round(rate_a, 4),
                                                  round(rate_b, 4)]
            table.setdefault(key_b, {})[key_a] = [round(rate_b, 4),
                                                  round(rate_a, 4)]
            print(f"{args.worker_type} {key_a} + {key_b}: "
                  f"{rate_a:.3f} / {rate_b:.3f} steps/s", flush=True)

    oracle.setdefault("__meta__", {}).setdefault("throughput_detail", {})[
        args.worker_type] = provenance(args.device, args.steps, args.warmup,
                                       [f"{family}:{bs}" for family, bs in rows])
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(oracle, f, indent=1, sort_keys=True)
    print(f"wrote {args.output}")
    if args.trace_out:
        obs.tracer.export_chrome_trace(args.trace_out)
        print(f"wrote {args.trace_out}")
    return obs


if __name__ == "__main__":
    main()
