#!/usr/bin/env python3
"""Deployed-conditions oracle calibration through the real runtime stack.

The port of the JAX package's `scripts/profiling/measure_deployed.py`,
with its CLI, its log parser and the keys it writes. The in-process
profiler (`measure_throughput.py`) times steps with the job alone on the
card. Deployed, the scheduler, the port's worker daemon, the trainer and
the next job's start-up share the host, and each preemption cycle
carries dead time outside the lease (trainer exit, checkpoint save, the
Done RPC, the round's rollover and the next trainer's unhidden start-up:
interpreter, torch import, model build, checkpoint restore, the kernel
library's load). Both are properties of the deployment, so they belong
in the oracle.

For each family this script runs a 2-job single-worker physical loopback
(two jobs of the family force an alternating preempt / redispatch cycle)
for `--rounds` rounds: the unchanged `scripts/drivers/run_physical.py`
as a subprocess, planning from the oracle file itself (`--throughputs`),
and the port's worker (`python -m shockwave_tpu_torch.runtime.worker`).
Then it reads the per-round logs of the port's `LeaseIterator` to
measure:

  - the deployed rate: steps / in-lease seconds over all leases after
    round 0, written over the family's `('family', 1)` row;
  - the round drain: the mean cycle excess over the round (init-to-init
    gap minus the round), `__meta__.round_drain_s[_by_type]`;
  - the lease shortfall: the round minus the mean in-lease duration, the
    unhidden start-up that shrinks the step window,
    `__meta__.lease_shortfall_s[_by_type]` (the simulator prefers it to
    `measure_startup.py`'s spawn -> exit proxy, `dispatch_overhead_s`);

with each family's solo rate beside its deployed rate under
`__meta__.deployed_calibration[worker_type]["sf=1"]`.

    python -m shockwave_tpu_torch.profiling.measure_deployed \\
        --worker_type h100 --oracle data/h100_throughputs.json \\
        --round_duration 60 --rounds 4

The jobs train on the card; `--device cpu` appends `--device cpu` to
each command and gives the worker one chip. Not ported, and refused: a
gang's calibration (`--scale_factor` above 1) and the co-resident regime
(`--concurrent`), which both need more than one card.
"""
import argparse
import contextlib
import dataclasses
import datetime
import glob
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

from ..core.job import Job
from ..core.job_table import JOB_TABLE
from ..core.trace import job_to_trace_line
from .measure_throughput import GANG_ITEM

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN_PHYSICAL = os.path.join(REPO, "scripts", "drivers", "run_physical.py")
LOG_TS = "%Y-%m-%d %H:%M:%S"
DEFAULT_FAMILIES = ["ResNet-18 (batch size 32)", "LM (batch size 20)",
                    "Recommendation (batch size 512)"]
# The job templates this script calibrates, by job type.
TEMPLATES = {t.model: t for t in JOB_TABLE}


def free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _stop(proc, grace_s=20.0):
    """End `proc` and every process of its session (the worker's
    trainers): SIGTERM, then SIGKILL after `grace_s`."""
    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            pass
    with contextlib.suppress(ProcessLookupError):  # the group may be gone
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def run_calibration(template, steps_per_job, duration, round_s, rounds, data_dir, timeout,
                    oracle, worker_type, device="cuda"):
    """2-job loopback for `rounds` rounds; returns the checkpoint dir
    holding the per-round iterator logs (and the scheduler's and the
    worker's output, `scheduler.log` and `worker.log`)."""
    ckpt = tempfile.mkdtemp(prefix="swtpu_deployed_")
    trace = os.path.join(ckpt, "cal.trace")
    with open(trace, "w") as f:
        for _ in range(2):
            job = Job(None, template.model, template.command, template.working_directory,
                      template.num_steps_arg, needs_data_dir=template.needs_data_dir,
                      total_steps=steps_per_job, duration=duration)
            f.write(job_to_trace_line(job, 0.0) + "\n")
    port = free_port()
    with open(os.path.join(ckpt, "scheduler.log"), "w") as sched_log, \
            open(os.path.join(ckpt, "worker.log"), "w") as worker_log:
        sched = subprocess.Popen(
            [sys.executable, RUN_PHYSICAL, "--trace", trace, "--policy", "max_min_fairness",
             "--throughputs", oracle, "--expected_num_workers", "1",
             "--round_duration", str(round_s), "--port", str(port), "--timeout", str(timeout),
             "--max_rounds", str(rounds), "--output", os.path.join(ckpt, "out.pkl")],
            cwd=REPO, stdout=sched_log, stderr=subprocess.STDOUT, start_new_session=True)
        worker = None
        try:
            time.sleep(4)
            worker_cmd = [sys.executable, "-m", "shockwave_tpu_torch.runtime.worker",
                          "--worker_type", worker_type, "--sched_addr", "127.0.0.1",
                          "--sched_port", str(port), "--worker_port", str(free_port()),
                          "--data_dir", data_dir, "--checkpoint_dir", ckpt]
            if device == "cpu":
                worker_cmd += ["--num_chips", "1"]
            worker = subprocess.Popen(worker_cmd, cwd=REPO, stdout=worker_log,
                                      stderr=subprocess.STDOUT, start_new_session=True)
            sched.wait(timeout=timeout + 120)
        finally:
            for proc in (sched, worker):
                if proc is not None:
                    _stop(proc)
    return ckpt


def parse_rounds(ckpt):
    """[(round, load_end, lease_expiry, save_end, steps, lease_dur)]

    Gang ranks are aggregated per (job, round) with total-steps
    semantics (steps sum across ranks; duration is the slowest rank;
    load is the earliest rank in, save is the last rank out), so a
    record's steps/dur IS the gang's aggregate rate."""
    per_rank = {}
    for path in glob.glob(os.path.join(
            ckpt, "job_id=*", ".swtpu", "round=*", "worker=*.log")):
        job = int(re.search(r"job_id=(\d+)", path).group(1))
        rnd = int(re.search(r"round=(\d+)", path).group(1))
        load = exp = save_end = None
        steps = dur = None
        with open(path) as f:
            lines = f.readlines()
        for line in lines:
            m = re.match(r"\[(.*?)\] \[(.*?)\] \[(.*?)\]\s*(.*)", line)
            if not m:
                continue
            t = datetime.datetime.strptime(m.group(1), LOG_TS)
            ev, st, msg = m.group(2), m.group(3), m.group(4)
            if ev == "LOAD CHECKPOINT" and st == "END":
                load = t
            elif ev == "LEASE" and st in ("EXPIRED", "COMPLETE"):
                exp = t
                sm = re.match(r"(\d+) / \S+ steps, ([\d.]+)", msg)
                if sm:
                    steps, dur = int(sm.group(1)), float(sm.group(2))
            elif ev == "SAVE CHECKPOINT" and st == "END":
                save_end = t
        if load is not None:
            per_rank.setdefault((rnd, job), []).append(
                (load, exp, save_end, steps, dur))
    out = []
    for (rnd, job), ranks in sorted(per_rank.items()):
        load = min(r[0] for r in ranks)
        exps = [r[1] for r in ranks if r[1] is not None]
        saves = [r[2] for r in ranks if r[2] is not None]
        step_vals = [r[3] for r in ranks if r[3] is not None]
        dur_vals = [r[4] for r in ranks if r[4] is not None]
        out.append((rnd, load, max(exps) if exps else None,
                    max(saves) if saves else None,
                    sum(step_vals) if step_vals else None,
                    max(dur_vals) if dur_vals else None))
    return out


def _log_tail(ckpt, name, lines=40):
    path = os.path.join(ckpt, name)
    if not os.path.exists(path):
        return ""
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-lines:])


def calibrate(recs, round_s):
    """(deployed steps/s, lease durations, round drain, lease shortfall,
    usable leases) of one family's records; None when no lease after
    round 0 was parsed (round 0 is skipped: its cold start perturbs it).
    Gap and lease duration are paired per round record, so a round whose
    lease line is missing is dropped whole."""
    leases = [(s, d) for rnd, _, _, _, s, d in recs if rnd > 0 and s and d]
    if not leases:
        return None
    tput = sum(s for s, _ in leases) / sum(d for _, d in leases)
    lease_durs = [d for _, d in leases]
    cycles = []
    prev_exit = None
    for rnd, load, exp, save_end, s, d in recs:
        end = save_end or exp
        if prev_exit is not None and load is not None and rnd > 0 and s and d:
            cycles.append(((load - prev_exit).total_seconds(), d))
        if end is not None:
            prev_exit = end
    # Cycle excess over the round: everything outside the lease.
    cycle_excess = [g + (round_s - min(d, round_s)) for g, d in cycles]
    drain = statistics.mean(cycle_excess) if cycle_excess else 0.0
    shortfall = max(round_s - statistics.mean(lease_durs), 0.0)
    return tput, lease_durs, drain, shortfall, len(leases)


def solo_rate(oracle, worker_type, family):
    """The family's isolated rate: the one an earlier calibration kept
    beside its deployed rate, else the oracle row (`measure_throughput`),
    else a conservative 0.2 steps/s."""
    earlier = (oracle.get("__meta__", {}).get("deployed_calibration", {})
               .get(worker_type, {}).get("sf=1", {}).get("per_family", {}).get(family))
    if earlier and earlier.get("solo_steps_per_s"):
        return earlier["solo_steps_per_s"]
    return oracle.get(worker_type, {}).get(f"('{family}', 1)", {}).get("null") or 0.2


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worker_type", required=True)
    p.add_argument("--oracle", required=True)
    p.add_argument("--families", nargs="+", default=DEFAULT_FAMILIES)
    p.add_argument("--round_duration", type=float, default=120.0)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--data_dir", default=os.path.join(tempfile.gettempdir(), "swtpu_data"))
    p.add_argument("--timeout", type=float, default=1500.0)
    p.add_argument("--scale_factor", type=int, default=1,
                   help="refused above 1: a gang's calibration needs more than one card")
    p.add_argument("--concurrent", action="store_true",
                   help="refused: the co-resident regime needs more than one card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the jobs train (default: the CUDA card)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.scale_factor != 1:
        p.error(f"--scale_factor {args.scale_factor}: a gang's calibration needs more "
                f"than one card, {GANG_ITEM}")
    if args.concurrent:
        p.error(f"--concurrent: the co-resident regime needs more than one card, {GANG_ITEM}")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("measure_deployed: no CUDA device; pass --device cpu to "
                             "calibrate on the CPU")
    unknown = [f for f in args.families if f not in TEMPLATES]
    if unknown:
        raise SystemExit(f"unknown job types {unknown}; known: {sorted(TEMPLATES)}")

    with open(args.oracle) as f:
        oracle = json.load(f)
    rows = oracle.setdefault(args.worker_type, {})
    meta = oracle.setdefault("__meta__", {})
    drains, shortfalls, detail = [], [], {}
    for family in args.families:
        template = TEMPLATES[family]
        if args.device == "cpu":
            template = dataclasses.replace(template,
                                           command=f"{template.command} --device cpu")
        # Enough steps that neither job finishes inside the window.
        solo = solo_rate(oracle, args.worker_type, family)
        steps_per_job = max(int(solo * args.round_duration * args.rounds), 1)
        duration = int(args.rounds * args.round_duration * 4)
        ckpt = run_calibration(template, steps_per_job, duration, args.round_duration,
                               args.rounds, args.data_dir, args.timeout,
                               os.path.abspath(args.oracle), args.worker_type, args.device)
        try:
            recs = parse_rounds(ckpt)
            found = calibrate(recs, args.round_duration)
            if found is None:
                raise SystemExit(
                    f"{family}: no usable leases measured ({len(recs)} records)\n"
                    f"scheduler:\n{_log_tail(ckpt, 'scheduler.log')}\n"
                    f"worker:\n{_log_tail(ckpt, 'worker.log')}")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        tput, lease_durs, drain, shortfall, n_leases = found
        # The scheduler re-reads the file from disk: these land at the end.
        rows[f"('{family}', 1)"] = {"null": round(tput, 4)}
        meta.setdefault("lease_shortfall_s_by_type", {}).setdefault(
            args.worker_type, {})[family] = round(shortfall, 2)
        meta.setdefault("round_drain_s_by_type", {}).setdefault(
            args.worker_type, {})[family] = round(drain, 2)
        drains.append(drain)
        shortfalls.append(shortfall)
        detail[family] = {
            "deployed_steps_per_s": round(tput, 4),
            "solo_steps_per_s": solo,
            "scale_factor": 1,
            "concurrent": False,
            "leases": n_leases,
            "mean_lease_s": round(statistics.mean(lease_durs), 1),
            "mean_cycle_excess_s": round(drain, 1),
        }
        print(f"{family} sf=1: deployed {tput:.4f} steps/s (solo {solo}), lease shortfall "
              f"{shortfall:.1f}s, cycle excess {drain:.1f}s", flush=True)

    meta.setdefault("lease_shortfall_s", {})[args.worker_type] = round(
        statistics.mean(shortfalls), 2)
    meta.setdefault("round_drain_s", {})[args.worker_type] = round(statistics.mean(drains), 2)
    calibration = meta.setdefault("deployed_calibration", {}).setdefault(args.worker_type, {})
    per_family = dict(calibration.get("sf=1", {}).get("per_family", {}), **detail)
    calibration["sf=1"] = {
        "measured_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "method": "2-job alternating loopback (sf=1) via the real runtime (the port's "
                  f"worker, on {args.device}); steps/in-lease-second; cycle excess over round",
        "round_duration": args.round_duration,
        "per_family": per_family,
    }
    with open(args.oracle, "w") as f:
        json.dump(oracle, f, indent=1)
        f.write("\n")
    print(f"round_drain_s[{args.worker_type}] = {meta['round_drain_s'][args.worker_type]} "
          f"-> {args.oracle}", flush=True)


if __name__ == "__main__":
    main()
