"""Trace file IO, including the serving job class (a copy of
`shockwave_tpu/core/trace.py`).

A trace is a TSV with one job per line and 12 fields:
job_type, command, working_directory, num_steps_arg, needs_data_dir,
total_steps, scale_factor, mode, priority_weight, SLO, duration,
arrival_time (reference: scheduler/utils.py:1446-1497). SLO < 0 means none.

Serving jobs (the latency-SLO inference class; the port's replica is
`workloads/serving/serve.py`)
ride the same 12 fields with reinterpreted semantics:

- ``mode`` is ``"serving"`` (SERVING_MODE);
- ``SLO`` is the p99 latency target in SECONDS (not the training class's
  completion-deadline multiplier);
- ``duration`` is the service lifetime in seconds — the service retires
  when it elapses, there is no step budget to finish;
- ``command`` is the runnable replica invocation
  (workloads/serving/serve.py) and doubles as the carrier of the
  service's load-curve and capacity parameters (`serving_command` /
  `parse_serving_command` below), so a trace line is self-contained and
  the identical parameters drive the simulator's analytic model and the
  physical replica process.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .job import Job

#: Job.mode value marking the latency-SLO serving class.
SERVING_MODE = "serving"

#: Model token of serving job types ("Serving (batch size N)").
SERVING_MODEL = "Serving"

#: Flags of `serving_command` that carry float values.
_SERVING_FLOAT_FLAGS = frozenset({
    "base_rps", "peak_rps", "period_s", "phase_s", "spike_mult",
    "spike_duration_s", "decode_tokens_per_s",
})
#: Flags of `serving_command` that carry int values.
_SERVING_INT_FLAGS = frozenset({
    "tokens_per_request", "max_replicas", "spike_seed", "num_spikes",
    "batch_size", "replica_of", "replica_index",
})


def parse_trace(trace_file: str) -> Tuple[List[Job], List[float]]:
    jobs: List[Job] = []
    arrival_times: List[float] = []
    with open(trace_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) != 12:
                raise ValueError(f"expected 12 trace fields, got {len(fields)}: {line!r}")
            (job_type, command, working_directory, num_steps_arg, needs_data_dir,
             total_steps, scale_factor, mode, priority_weight, slo, duration,
             arrival_time) = fields
            if int(scale_factor) < 1:
                raise ValueError(f"scale_factor must be >= 1: {line!r}")
            jobs.append(Job(
                job_id=None,
                job_type=job_type,
                command=command,
                working_directory=working_directory,
                num_steps_arg=num_steps_arg,
                needs_data_dir=bool(int(needs_data_dir)),
                total_steps=int(total_steps),
                duration=duration,
                scale_factor=int(scale_factor),
                mode=mode,
                priority_weight=float(priority_weight),
                SLO=float(slo),
            ))
            arrival_times.append(float(arrival_time))
    return jobs, arrival_times


def is_serving_job(job: Job) -> bool:
    return job.mode == SERVING_MODE


def serving_command(base_rps: float, peak_rps: float, period_s: float,
                    tokens_per_request: int, decode_tokens_per_s: float,
                    max_replicas: int, phase_s: float = 0.0,
                    spikes: Sequence[Tuple[float, float, float]] = (),
                    spike_seed: Optional[int] = None, num_spikes: int = 0,
                    spike_mult: float = 10.0,
                    spike_duration_s: float = 1800.0,
                    batch_size: int = 1) -> str:
    """The runnable replica command, carrying the service parameters.

    `spikes` are explicit (start_offset_s, duration_s, multiplier)
    triples encoded as ``--spike_at start:dur:mult``; alternatively a
    `spike_seed` + `num_spikes` draws them deterministically at parse
    time (serving/load.seeded_spikes)."""
    parts = [
        "python3 serve.py",
        f"--batch_size {batch_size}",
        f"--base_rps {base_rps:g}", f"--peak_rps {peak_rps:g}",
        f"--period_s {period_s:g}", f"--phase_s {phase_s:g}",
        f"--tokens_per_request {tokens_per_request}",
        f"--decode_tokens_per_s {decode_tokens_per_s:g}",
        f"--max_replicas {max_replicas}",
    ]
    for start, dur, mult in spikes:
        parts.append(f"--spike_at {start:g}:{dur:g}:{mult:g}")
    if spike_seed is not None and num_spikes > 0:
        parts.append(f"--spike_seed {spike_seed}")
        parts.append(f"--num_spikes {num_spikes}")
        parts.append(f"--spike_mult {spike_mult:g}")
        parts.append(f"--spike_duration_s {spike_duration_s:g}")
    return " ".join(parts)


def parse_serving_command(command: str) -> Dict:
    """Inverse of `serving_command`: the service parameter dict.

    Tolerates extra flags (``--num_steps`` appended by the dispatcher,
    replica markers) — unknown flags are kept as strings so callers can
    inspect them. Raises ValueError on a malformed ``--spike_at``."""
    tokens = command.split()
    params: Dict = {}
    spikes: List[Tuple[float, float, float]] = []
    i = 0
    while i < len(tokens):
        token = tokens[i]
        if not token.startswith("--"):
            i += 1
            continue
        key = token[2:]
        value = tokens[i + 1] if i + 1 < len(tokens) else None
        if key == "spike_at":
            try:
                start, dur, mult = (float(x) for x in value.split(":"))
            except (AttributeError, ValueError):
                raise ValueError(
                    f"malformed --spike_at {value!r} (want start:dur:mult)"
                ) from None
            spikes.append((start, dur, mult))
        elif key in _SERVING_FLOAT_FLAGS:
            params[key] = float(value)
        elif key in _SERVING_INT_FLAGS:
            params[key] = int(value)
        else:
            params[key] = value
        i += 2
    if spikes:
        params["spikes"] = tuple(spikes)
    return params


def serving_service_rate(command: str) -> float:
    """Per-replica service rate mu in requests/s, from the command's
    decode rate and request length. Falls back to 1.0 when the command
    does not carry the parameters (hand-written traces)."""
    params = parse_serving_command(command)
    tokens_per_request = params.get("tokens_per_request", 0)
    decode = params.get("decode_tokens_per_s", 0.0)
    if tokens_per_request and decode > 0:
        return decode / tokens_per_request
    return 1.0


def make_serving_job(base_rps: float, peak_rps: float, period_s: float,
                     lifetime_s: float, slo_p99_s: float,
                     tokens_per_request: int = 64,
                     decode_tokens_per_s: float = 1600.0,
                     max_replicas: int = 8, batch_size: int = 1,
                     **command_kwargs) -> Job:
    """One serving-service trace job (the anchor the scheduler's serving
    tier expands into autoscaled replica jobs)."""
    return Job(
        job_id=None,
        job_type=f"{SERVING_MODEL} (batch size {batch_size})",
        command=serving_command(
            base_rps=base_rps, peak_rps=peak_rps, period_s=period_s,
            tokens_per_request=tokens_per_request,
            decode_tokens_per_s=decode_tokens_per_s,
            max_replicas=max_replicas, batch_size=batch_size,
            **command_kwargs),
        working_directory="serving",
        num_steps_arg="--num_steps",
        needs_data_dir=False,
        total_steps=0,
        duration=lifetime_s,
        scale_factor=1,
        mode=SERVING_MODE,
        priority_weight=1.0,
        SLO=slo_p99_s,
    )


def job_to_trace_line(job: Job, arrival_time: float) -> str:
    slo = -1.0 if job.SLO is None else job.SLO
    fields = [
        job.job_type, job.command, job.working_directory, job.num_steps_arg,
        str(int(job.needs_data_dir)), str(job.total_steps),
        str(job.scale_factor), job.mode, str(int(job.priority_weight)),
        f"{slo:f}", str(job.duration), f"{arrival_time:f}",
    ]
    return "\t".join(fields)
