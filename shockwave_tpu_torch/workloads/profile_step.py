#!/usr/bin/env python3
"""Where a training step of one workload spends its time on the card.

    python3 -m shockwave_tpu_torch.workloads.profile_step \
        [--family translation|lm|recommendation|cifar10|imagenet|a3c|cyclegan|flagship_long] \
        [--batch_size N] [--steps 5]

Builds the family's full-width trainer through its main's
`build_trainer` or `build_job` (the translation Transformer at batch 64
with flash on by default; the other families at their largest batch,
`MAX_BS`: A3C with 4 environments, CycleGAN at 1 x 128 x 128) and
lets it take `--warmup` steps on one batch; `flagship_long` is
`profiling/bench_gpu.py`'s flagship at T = 2048 (batch 4 by default,
Adam, K1-K3 in the model). Then, on the same batch:

- `--steps` steps timed on the host clock between two synchronisations,
  with the profiler off (`ms_per_step`);
- `--steps` more steps under `torch.profiler` (CUDA activity only):
  the device's busy time per step (the union of its kernel and memory
  intervals), its idle share of the profiled window, kernel launches per
  step, and device time per kernel group and for the top kernels.

Prints one JSON line. Runs on the card only.
"""
import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), *[".."] * 2))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from shockwave_tpu_torch.models.train_common import upload  # noqa: E402

# family: (main module, default batch, the trace's CLI at batch b)
FAMILIES = {
    "translation": ("translation.train", 64,
                    lambda b: ["-batch_size", b, "-proj_share_weight", "--use_flash"]),
    "lm": ("language_modeling.main", 80, lambda b: ["--cuda", "--batch_size", b]),
    "recommendation": ("recommendation.train", 8192, lambda b: ["--batch_size", b]),
    "cifar10": ("image_classification.cifar10.main", 256, lambda b: ["--batch_size", b]),
    "imagenet": ("image_classification.imagenet.main", 128, lambda b: ["-b", b]),
    "a3c": ("rl.main", 4, lambda b: ["--workers", b]),
    "cyclegan": ("cyclegan.cyclegan", 1, lambda b: ["--batch_size", b]),
    "flagship_long": (None, 4, None),
}
LONG_SEQ = 2048

# Kernel groups, by a piece of the kernel's name (first match wins).
GROUPS = (("flash_fwd", ("flash_fwd_kernel",)), ("flash_dq", ("flash_dq_kernel",)),
          ("flash_dkv", ("flash_dkv_kernel",)),
          ("conv", ("fprop", "dgrad", "wgrad", "conv")),
          ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
          ("lstm", ("lstm", "rnn")),
          ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")),
          ("optimizer", ("multi_tensor", "foreach")),
          ("softmax_and_loss", ("softmax", "nll", "cross_entropy", "log_softmax")),
          ("reduce", ("reduce",)))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def union_us(intervals):
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", choices=sorted(FAMILIES), default="translation")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step runs on the CUDA card only")

    module, default_batch, head = FAMILIES[args.family]
    batch_size = args.batch_size or default_batch
    if module is None:
        from shockwave_tpu_torch.models.train_common import resolve_device
        from shockwave_tpu_torch.profiling.bench_gpu import flagship
        resolve_device("cuda")  # TF32 off, as for every trainer
        _, step = flagship(batch_size, LONG_SEQ)
    else:
        main_module = importlib.import_module(f"shockwave_tpu_torch.workloads.{module}")
        if hasattr(main_module, "build_job"):
            trainer, loader, _ = main_module.build_job(head(str(batch_size)))
        else:
            trainer = main_module.build_trainer(head(str(batch_size)))
            loader = trainer.data_loader
        batch = tuple(upload(b, trainer.device) for b in next(iter(loader)))

        def step():
            return trainer.train_step(*batch)
    for _ in range(args.warmup):
        step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / args.steps

    # Device activity only: recording every host-side op as well slows the
    # host enough to change the idle share being measured.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    intervals, per_group, per_kernel = [], {}, {}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        start, end = event.time_range.start, event.time_range.end
        intervals.append((start, end))
        us = end - start
        group = group_of(event.name)
        per_group[group] = per_group.get(group, 0.0) + us
        total, count = per_kernel.get(event.name, (0.0, 0))
        per_kernel[event.name] = (total + us, count + 1)
    busy_ms = union_us(intervals) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "family": args.family, "batch_size": batch_size,
        "device": torch.cuda.get_device_name(0), "steps": args.steps,
        "ms_per_step": ms_per_step, "profiled_ms_per_step": window_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / window_ms if window_ms else None,
        "device_events_per_step": len(intervals) / args.steps,
        "group_ms_per_step": {g: us / 1e3 / args.steps
                              for g, us in sorted(per_group.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": name[:100], "ms_per_step": us / 1e3 / args.steps,
                         "calls_per_step": n / args.steps} for name, (us, n) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
