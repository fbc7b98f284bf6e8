#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once, on one H100:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's end-to-end metrics
(`--trace 0`) or its per-layer metrics (`--trace 1`) as one JSON object,
the last line of standard output, and each number that decides `correct`
beside its limit, as the last lines of standard error and under
`checks`, the result's last key. Exits 2, printing no result, without a
CUDA card or with fewer cards than the cell asks for, and 3 if a module
of JAX or of the JAX package was loaded. The program's build and kernel
caches stay inside the checkout, under `.bench_cache/` (the port's own
nvcc library under `shockwave_tpu_torch/csrc/build/`). CUDA's launch
queue is made four times deeper (`CUDA_SCALE_LAUNCH_QUEUES`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = os.path.join(CACHE, _sub)
# CUDA's launch queue four times its default depth: the host, whose eager
# step takes about half the card's time, then runs further ahead of the
# card, and a stall of the host's cores no longer idles it.
os.environ["CUDA_SCALE_LAUNCH_QUEUES"] = "4x"
# The repository's root in place of this script's directory, whose module
# names would shadow others.
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.load(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
