"""Throughput oracle files (a copy of `shockwave_tpu/core/oracle.py`).

Format (reference: scheduler/utils.py:575-594 and *_throughputs.json):

    {worker_type: {"('<job_type>', <scale_factor>)":
        {"null": isolated_tput,
         "('<other_job_type>', <sf>)": [tput_self, tput_other]}}}

Keys are stringified (job_type, scale_factor) tuples; "null" holds the
isolated throughput in steps/sec.

A top-level "__meta__" entry (not in the reference format) carries
measurement metadata alongside the numbers it calibrates, e.g.

    {"__meta__": {"dispatch_overhead_s": {"cpu": 22.4},
                  "measured_at": "...", ...}, "cpu": {...}}

`dispatch_overhead_s` is the measured per-dispatch dead time per
worker type: the full spawn -> exit wall time of a 1-step run
(interpreter + torch import, data load, checkpoint restore, the first
step, and the exit-path checkpoint save) as measured by
`profiling/measure_startup.py`. `lease_shortfall_s` (+
`lease_shortfall_s_by_type`) is the deployed-conditions in-lease
shortfall, which the JAX package's `scripts/profiling/measure_deployed.py`
measures (not ported yet) — a different quantity under a deliberately
different key, preferred by the scheduler's calibrated overhead model
when both are present (`shockwave_tpu/sched/scheduler.py`
`_cold_dispatch_overhead`). `read_throughputs` skips the entry so
every existing consumer sees the plain oracle mapping.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Optional, Tuple

JobTypeKey = Tuple[str, int]

_KEY_RE = re.compile(r"\('(.*)', (\d+)\)")


def parse_job_type_tuple(s: str) -> Optional[JobTypeKey]:
    m = _KEY_RE.match(s)
    if m is None:
        return None
    return (m.group(1), int(m.group(2)))


def read_oracle(path: str) -> Tuple[Dict[str, Dict[JobTypeKey, dict]], dict]:
    """Load an oracle file once: (throughputs, __meta__ or {})."""
    with open(path) as f:
        raw = json.load(f)
    meta = raw.get("__meta__", {})
    if not isinstance(meta, dict):
        raise ValueError(f"__meta__ in {path} must be an object")
    out: Dict[str, Dict[JobTypeKey, dict]] = {}
    for worker_type, per_type in raw.items():
        if worker_type == "__meta__":
            continue
        parsed = {}
        for job_type_str, entry in per_type.items():
            key = parse_job_type_tuple(job_type_str)
            if key is None:
                raise ValueError(f"bad job type key {job_type_str!r}")
            parsed_entry = {}
            for other, tput in entry.items():
                parsed_entry["null" if other == "null" else parse_job_type_tuple(other)] = tput
            parsed[key] = parsed_entry
        out[worker_type] = parsed
    return out, meta


def read_throughputs(path: str) -> Dict[str, Dict[JobTypeKey, dict]]:
    """Load an oracle file, parsing stringified keys into tuples."""
    return read_oracle(path)[0]


def read_oracle_meta(path: str) -> dict:
    """The oracle file's "__meta__" entry ({} when absent)."""
    return read_oracle(path)[1]


def write_throughputs(path: str, throughputs: Dict[str, Dict[JobTypeKey, dict]]) -> None:
    raw = {
        worker_type: {
            str(key): {
                ("null" if other == "null" else str(other)): tput
                for other, tput in entry.items()
            }
            for key, entry in per_type.items()
        }
        for worker_type, per_type in throughputs.items()
    }
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)
