#!/usr/bin/env python3
"""Per-dispatch startup profiler: calibrate the simulator's cold-dispatch
overhead for a port worker.

The port of the JAX package's `scripts/profiling/measure_startup.py`.
Every physical (re)dispatch of a job pays a fixed cost the throughput
oracle cannot see: interpreter and torch import, model build and move to
the card, input-pipeline setup, checkpoint restore, the first step, and
the exit-path checkpoint save. This script measures that cost the way
the dispatcher incurs it — by spawning the trace's own commands
(`core/job_table.py` templates) under the port's run dir
(`shockwave_tpu_torch/workloads`, `runtime/worker.py` `RUN_DIR`) for a
1-step run and timing spawn -> exit — and writes the mean into the
oracle file's ``__meta__.dispatch_overhead_s[worker_type]`` (with
``dispatch_overhead_detail``, the reference's keys), which activates
the simulator's calibrated cold-dispatch model.

For each job type the first run is discarded and kept as
``cold_compile_s``: in the port that is the kernel library's build or
load (`ops/_build.py`, for the Transformer) and cold file caches, where
the reference's is the XLA compile cache. Then ``--repeats`` runs are
measured, each restoring the checkpoint the previous run saved.

    python -m shockwave_tpu_torch.profiling.measure_startup \\
        --oracle data/h100_throughputs.json [--families "LM (batch size 20)"]

The jobs run on the card; `--device cpu` appends `--device cpu` to each
command.
"""
import argparse
import dataclasses
import datetime
import json
import os
import platform
import shlex
import shutil
import statistics
import subprocess
import tempfile
import time

from ..core.job_table import JOB_TABLE, a3c, cyclegan

WORKLOADS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "workloads")


def run_once(template, data_dir, ckpt_dir, timeout):
    """Spawn the workload exactly like the dispatcher does, for 1 step;
    return wall seconds from spawn to exit."""
    command = template.command
    if template.needs_data_dir and "%s" in command:
        command = command % (data_dir,)
    command = (f"{command} --local_rank 0 {template.num_steps_arg} 1 "
               f"--checkpoint_dir {ckpt_dir}")
    cwd = os.path.join(WORKLOADS, template.working_directory)
    t0 = time.monotonic()
    proc = subprocess.run(
        shlex.split(command), cwd=cwd, timeout=timeout,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    elapsed = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"{template.model}: exit {proc.returncode}:\n"
            f"{proc.stdout.decode(errors='replace')[-2000:]}")
    return elapsed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worker_type", default="h100")
    p.add_argument("--oracle", required=True,
                   help="throughput-oracle JSON to write __meta__ into")
    p.add_argument("--families", nargs="+",
                   default=["ResNet-18 (batch size 32)", "LM (batch size 20)",
                            "Recommendation (batch size 512)"],
                   help="job_type strings (job_table models) to profile")
    p.add_argument("--repeats", type=int, default=2,
                   help="measured runs per family after the first")
    p.add_argument("--data_dir", default=os.path.join(tempfile.gettempdir(), "swtpu_data"),
                   help="dataset root; absent datasets fall back synthetic")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the jobs train (default: the CUDA card)")
    args = p.parse_args(argv)

    by_model = {t.model: t for t in JOB_TABLE + [a3c(), cyclegan()]}
    per_family = {}
    for family in args.families:
        if family not in by_model:
            raise SystemExit(f"unknown job type {family!r}; "
                             f"known: {sorted(by_model)}")
        template = by_model[family]
        if args.device == "cpu":
            template = dataclasses.replace(
                template, command=f"{template.command} --device cpu")
        ckpt_dir = tempfile.mkdtemp(prefix="swtpu_startup_")
        try:
            warmup = run_once(template, args.data_dir, ckpt_dir, args.timeout)
            samples = [run_once(template, args.data_dir, ckpt_dir,
                                args.timeout)
                       for _ in range(args.repeats)]
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        per_family[family] = {
            "cold_compile_s": round(warmup, 2),
            "samples_s": [round(s, 2) for s in samples],
            "mean_s": round(statistics.mean(samples), 2),
        }
        print(f"{family}: first run {warmup:.1f}s, "
              f"measured {per_family[family]['samples_s']}")

    overhead = round(statistics.mean(
        f["mean_s"] for f in per_family.values()), 2)

    with open(args.oracle) as f:
        oracle = json.load(f)
    meta = oracle.setdefault("__meta__", {})
    meta.setdefault("dispatch_overhead_s", {})[args.worker_type] = overhead
    meta.setdefault("dispatch_overhead_detail", {})[args.worker_type] = {
        "measured_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "host": platform.node(),
        "python": platform.python_version(),
        "method": "spawn->exit of 1-step runs after a discarded first run "
                  "(kernel-library build or load, cold file caches), "
                  "ckpt restore+save included; mean over families",
        "per_family": per_family,
    }
    with open(args.oracle, "w") as f:
        json.dump(oracle, f, indent=1)
        f.write("\n")
    print(f"dispatch_overhead_s[{args.worker_type}] = {overhead} "
          f"-> {args.oracle}")


if __name__ == "__main__":
    main()
