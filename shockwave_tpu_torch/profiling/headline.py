#!/usr/bin/env python3
"""The port's headline line: the canonical trace's simulation on the H100
oracle, beside what the card itself measures.

    python -m shockwave_tpu_torch.profiling.headline [--policy shockwave]
        [--max_rounds N] [--device cuda]

Phases, each a subprocess:

1. simulation: the JAX package's `scripts/drivers/simulate.py`, unchanged
   (its scheduler imports no JAX), replays `data/canonical_120job.trace`
   under `--policy` on `data/h100_throughputs.json`, `--cluster_spec
   h100:32`, 120 s rounds (up to `--max_rounds` rounds when given):
   makespan, average JCT and unfair fraction in simulated seconds, the
   subprocess's wall (`sim_wall_s`, as `bench.py` times its replay) and
   the simulator's own `sim_core_wall_s` and `milp_wall_s`.
2. bench_gpu: `profiling/bench_gpu.py` on the card (nothing saved): the
   flagship's steps/s at batch 128 x T 64, its MFU at T 2048 (batch 4),
   and flash against einsum attention ms at (4, 2048, 8, 64).
3. decode: `profiling/bench_serving_decode.py` at its defaults on the
   card: the replica's tokens/s per card, requests/s and backend.
4. device: the card's `nvidia-smi` name and power limit
   (`profiling/device.nvidia_smi`).

Prints ONE JSON line holding every key of `KEYS`. Unlike `bench.py`'s
TPU phase there is no fallback to committed numbers: a phase that fails
leaves its keys null, puts `<phase>_error` in the line, and the process
exits 1. The card phases run on the card unless `--device cpu` is given
(a CPU has no published peak, so its MFU is null, and no `nvidia-smi`
line); `--bench_gpu_args` and `--decode_args` pass more arguments to the
two benches (a small run on the CPU).
"""
import argparse
import json
import os
import shlex
import subprocess
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
TRACE = os.path.join("data", "canonical_120job.trace")
THROUGHPUTS = os.path.join("data", "h100_throughputs.json")
CLUSTER_SPEC = "h100:32"
ROUND_DURATION_S = 120

# Every key of the line: what it ran, then what the simulation, bench_gpu,
# the decode bench and the device phase fill.
KEYS = ("metric", "value", "unit", "policy", "cluster_spec", "throughputs", "max_rounds",
        "device_arg",
        "makespan", "avg_jct", "unfair_fraction", "rounds", "sim_wall_s", "sim_core_wall_s",
        "milp_wall_s",
        "flagship_steps_per_s", "flagship_batch", "flagship_seq_len", "long_mfu", "long_batch",
        "long_seq_len", "attn_flash_ms", "attn_einsum_ms", "attn_shape",
        "serving_tokens_per_s_per_chip", "serving_requests_per_s", "serving_decode_backend",
        "serving_decode_device_kind",
        "card", "power_limit", "nvidia_smi", "headline_wall_s")


def last_json_line(cmd, timeout):
    """The JSON object on the last stdout line of `cmd` run from the repo
    root; raises with the end of its stderr when it fails."""
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    if out.returncode != 0:
        raise RuntimeError(f"exit {out.returncode}: {out.stderr[-500:]}")
    lines = out.stdout.strip().splitlines()
    if not lines:
        raise RuntimeError(f"no output: {out.stderr[-500:]}")
    return json.loads(lines[-1])


def simulation_phase(args):
    cmd = [sys.executable, os.path.join("scripts", "drivers", "simulate.py"),
           "--trace", TRACE, "--policy", args.policy, "--throughputs", THROUGHPUTS,
           "--cluster_spec", CLUSTER_SPEC, "--round_duration", str(ROUND_DURATION_S)]
    if args.max_rounds is not None:
        cmd += ["--max_rounds", str(args.max_rounds)]
    t0 = time.monotonic()
    result = last_json_line(cmd, timeout=3600)
    return {"makespan": result["makespan"], "avg_jct": result["avg_jct"],
            "unfair_fraction": result["unfair_fraction"], "rounds": result.get("rounds"),
            "sim_wall_s": round(time.monotonic() - t0, 1),
            "sim_core_wall_s": result.get("sim_core_wall_s"),
            "milp_wall_s": result.get("milp_wall_s")}


def bench_gpu_phase(args):
    row = last_json_line([sys.executable, "-m", "shockwave_tpu_torch.profiling.bench_gpu",
                          "--device", args.device, "--save_dir", "",
                          *shlex.split(args.bench_gpu_args)], timeout=1800)
    return {"flagship_steps_per_s": row["transformer_steps_per_s"],
            "flagship_batch": row["transformer_batch"],
            "flagship_seq_len": row["transformer_seq_len"],
            "long_mfu": row["transformer_long_mfu"],
            "long_batch": row["transformer_long_batch"],
            "long_seq_len": row["transformer_long_seq_len"],
            "attn_flash_ms": row["flash_attn_ms"], "attn_einsum_ms": row["einsum_attn_ms"],
            "attn_shape": row["attn_shape"]}


def decode_phase(args):
    row = last_json_line([sys.executable, "-m",
                          "shockwave_tpu_torch.profiling.bench_serving_decode",
                          "--device", args.device, *shlex.split(args.decode_args)],
                         timeout=900)
    return {"serving_tokens_per_s_per_chip": row["tokens_per_s_per_chip"],
            "serving_requests_per_s": row["requests_per_s"],
            "serving_decode_backend": row["backend"],
            "serving_decode_device_kind": row["device_kind"]}


def device_phase(args):
    if args.device != "cuda":
        return {"card": args.device}
    from .device import nvidia_smi
    smi = nvidia_smi()
    name, _, limit = smi.rpartition(", ")
    return {"card": name, "power_limit": limit, "nvidia_smi": smi}


PHASES = {"simulation": simulation_phase, "bench_gpu": bench_gpu_phase,
          "decode": decode_phase, "device": device_phase}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--policy", default="shockwave")
    p.add_argument("--max_rounds", type=int, default=None,
                   help="stop the simulation after this many rounds (default: all)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the card phases run (default: the CUDA card)")
    p.add_argument("--bench_gpu_args", default="", help="more arguments for bench_gpu")
    p.add_argument("--decode_args", default="",
                   help="more arguments for bench_serving_decode")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    t0 = time.monotonic()
    line = dict.fromkeys(KEYS)
    line.update(metric=f"h100_canonical_{args.policy}_makespan", unit="s",
                policy=args.policy, cluster_spec=CLUSTER_SPEC, throughputs=THROUGHPUTS,
                max_rounds=args.max_rounds, device_arg=args.device)
    failed = []
    for name, phase in PHASES.items():
        try:
            line.update(phase(args))
        except Exception as e:  # noqa: BLE001 - the line carries every phase's failure
            line[f"{name}_error"] = f"{type(e).__name__}: {e}"[-800:]
            failed.append(name)
    line["value"] = line["makespan"]
    line["headline_wall_s"] = round(time.monotonic() - t0, 1)
    print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
