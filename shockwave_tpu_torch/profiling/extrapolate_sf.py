#!/usr/bin/env python3
"""Seed scale_factor > 1 oracle rows from measured scaling efficiencies.

A copy of the JAX package's `scripts/profiling/extrapolate_sf.py`, with
the same arithmetic and output. For each measured sf = 1 row it derives
a documented prior for each (job_type, sf) row:

    rate(sf) = rate(1) * sf * efficiency_ref(job_type, sf)

where efficiency_ref comes from the reference's committed multi-GPU
oracle (data/tacc_throughputs.json, read as a file): its (job_type, sf)
rows are real measurements of data-parallel synchronization cost per
family and batch size. Estimated rows are recorded in
__meta__.estimated_rows with their provenance so they are never mistaken
for measurements; existing (measured) rows are never overwritten.

The committed `data/h100_throughputs.json` carries its sf 2 and 4
priors, written by

    python -m shockwave_tpu_torch.profiling.extrapolate_sf \\
        --oracle data/h100_throughputs.json --worker_type h100 --sfs 2 4

(a port job of scale factor N trains as an N-rank gang; measuring a
gang's rate needs a machine with N cards, ROADMAP.md Queue 1, item 12).
`--oracle` and `--worker_type` are required, so no file is written by
default.
"""
import argparse
import datetime
import json
import os

from ..core.oracle import parse_job_type_tuple

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--oracle", required=True)
    p.add_argument("--worker_type", required=True)
    p.add_argument("--ratios", default=os.path.join(
        REPO, "data", "tacc_throughputs.json"),
        help="oracle whose (job_type, sf) rows provide scaling ratios")
    p.add_argument("--ratio_worker", default="v100")
    p.add_argument("--sfs", type=int, nargs="+", default=[2, 4, 8])
    args = p.parse_args(argv)

    with open(args.ratios) as f:
        ref = json.load(f)[args.ratio_worker]
    eff = {}  # (family, sf) -> measured efficiency vs sf * rate(1)
    base_rate = {}
    for key_str, entry in ref.items():
        key = parse_job_type_tuple(key_str)
        if key and entry.get("null"):
            if key[1] == 1:
                base_rate[key[0]] = entry["null"]
    for key_str, entry in ref.items():
        key = parse_job_type_tuple(key_str)
        if (key and entry.get("null") and key[1] > 1
                and base_rate.get(key[0])):
            eff[key] = entry["null"] / (base_rate[key[0]] * key[1])

    with open(args.oracle) as f:
        oracle = json.load(f)
    rows = oracle[args.worker_type]
    added = {}
    for key_str in list(rows):
        key = parse_job_type_tuple(key_str)
        if key is None or key[1] != 1:
            continue
        rate1 = rows[key_str].get("null")
        if not rate1:
            continue
        for sf in args.sfs:
            new_key = str((key[0], sf))
            if new_key in rows:
                continue  # never overwrite a measured row
            e = eff.get((key[0], sf))
            if e is None:
                continue  # family has no reference scaling measurement
            rows[new_key] = {"null": round(rate1 * sf * e, 4)}
            added[new_key] = {"from_sf1": rate1,
                              "reference_efficiency": round(e, 4)}

    meta = oracle.setdefault("__meta__", {})
    est = meta.setdefault("estimated_rows", {}).setdefault(
        args.worker_type, {})
    est.update(added)
    # The note is the reference's, word for word, so that both tools
    # write the same file from the same input.
    meta.setdefault("estimated_rows_note", (
        "rate(sf) = measured_rate(1) * sf * reference_efficiency(job, sf); "
        "efficiencies from the reference's measured multi-GPU oracle "
        f"({os.path.relpath(args.ratios, REPO)}[{args.ratio_worker}]). "
        "Conservative prior for ICI; refined online by EMA updates."))
    meta["estimated_rows_updated_at"] = datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")

    with open(args.oracle, "w") as f:
        json.dump(oracle, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"added {len(added)} estimated rows to "
          f"{args.oracle}[{args.worker_type}]")


if __name__ == "__main__":
    main()
