#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the program's three checked steps (as a
run takes them, after the warm-up), the
control (the reference in the program's place, its bf16 products in
emulated fp8, `reference/products.py`), the witness (the reference with
its products rounded to bf16) and, with `--faults`, the program
with each planted fault (`faults.py`), each compared with the float32
reference as a run compares them (`check.compare`).

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--faults]

Prints one JSON line a reading and, last, the largest and the smallest
of each number by kind. No window is run: the readings are of the
checked steps, which need none. Benchmark runs never run this.
"""
import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def program_readings(cell, seed, device, patch=None):
    import torch

    from benchmark import generator, harness
    from benchmark.weights import make_weights
    trainer = cell.driver.build_trainer(cell.config, cell.mix, device)
    spec = cell.driver.param_spec(cell.config)
    harness._load_weights(trainer, spec, make_weights(spec, seed, trainer.device))
    pool = generator.make(cell.mix, cell.config, seed, trainer.device)
    if patch is not None:
        patch(trainer)
    readings, checked, _ = harness.checked_steps(trainer, pool, spec, seed,
                                                 harness.Launches({}))
    del trainer, pool
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return readings, checked


def readings(cell, seed, device, faults=()):
    """[(kind, numbers, where)] of one seed."""
    from benchmark import check, harness
    from benchmark.faults import FAULTS
    prog, pool = program_readings(cell, seed, device)
    ref = harness.reference_readings(cell, seed, pool, pool[0].tensors[0].device)
    rows = [("program",) + check.compare(prog, ref)]
    ctl = harness.reference_readings(cell, seed, pool, pool[0].tensors[0].device, "fp8")
    rows.append(("control_fp8",) + check.compare(ctl, ref))
    wit = harness.reference_readings(cell, seed, pool, pool[0].tensors[0].device, "bf16")
    rows.append(("witness_bf16",) + check.compare(wit, ref))
    for name in faults:
        got, _ = program_readings(cell, seed, device, FAULTS[name])
        rows.append((f"fault_{name}",) + check.compare(got, ref))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", action="store_true",
                   help="also plant the faults that need a run (half_batch, altered)")
    args = p.parse_args(argv)
    import torch

    from benchmark import check, spec
    if not torch.cuda.is_available():
        print("control.py runs on the CUDA card", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    by_kind = {}
    for seed in args.seeds:
        for kind, numbers, where in readings(cell, seed, "cuda",
                                             ("half_batch", "altered") if args.faults else ()):
            print(json.dumps({"seed": seed, "kind": kind, **numbers, "where": where}), flush=True)
            by_kind.setdefault(kind, []).append(numbers)
    summary = {kind: {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                      for k in check.NUMBERS} for kind, rows in by_kind.items()}
    print(json.dumps({"workload": args.workload, "range": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
