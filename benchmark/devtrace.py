"""The reduction of a `torch.profiler` trace (CUDA activity only) to what
the per-layer metrics and the breakdown read.

`GROUPS`, `group_of` and `union_us` are frozen copies of the port's
`workloads/profile_step.py`, with one group added (`elementwise`,
PyTorch's elementwise kernels: casts, copies, adds, activations).
Device busy time is the union of the device's kernel and memory
intervals. An idle gap on the device is put down to the harness's host
span that holds its midpoint (`forward`: inside the loss function;
`backward_optimizer`: the rest of `Trainer.train_step`;
`between_steps`), and to the kernel group the device ran next.
"""
from __future__ import annotations

from torch.autograd import DeviceType

# Kernel groups, by a piece of the kernel's name (first match wins).
GROUPS = (("flash_bwd_delta", ("flash_bwd_delta",)), ("flash_fwd", ("flash_fwd",)),
          ("flash_dq", ("flash_dq",)), ("flash_dkv", ("flash_dkv",)),
          ("conv", ("fprop", "dgrad", "wgrad", "conv")),
          ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
          ("lstm", ("lstm", "rnn")),
          ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")),
          ("optimizer", ("multi_tensor", "foreach")),
          ("softmax_and_loss", ("softmax", "nll", "cross_entropy", "log_softmax")),
          ("reduce", ("reduce",)),
          ("elementwise", ("elementwise",)))


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


def _span_at(spans, t_ns):
    """The name of the span in `spans` ((start ns, end ns, name), sorted)
    that holds `t_ns`, else `outside`."""
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][0] <= t_ns:
            lo = mid + 1
        else:
            hi = mid
    if lo and spans[lo - 1][0] <= t_ns < spans[lo - 1][1]:
        return spans[lo - 1][2]
    return "outside"


def summarize(prof, spans, top: int = 10) -> dict:
    """Busy seconds, seconds per kernel group and per kernel, and idle
    seconds by (host span, next group) of the profiled window; `spans`
    are the harness's host spans as (start ns, end ns, name) on the
    clock of `time.time_ns`."""
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    intervals = sorted((e.time_range.start, e.time_range.end, e.name) for e in events)
    per_group, per_kernel = {}, {}
    for start, end, name in intervals:
        us = end - start
        group = group_of(name)
        per_group[group] = per_group.get(group, 0.0) + us / 1e6
        total, count = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (total + us / 1e6, count + 1)
    try:  # the trace's clock: microseconds after its start, in Unix ns
        origin_ns = prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        origin_ns = None
    spans = sorted(spans)
    gaps, end = {}, None
    for start, stop, name in intervals:
        if end is not None and start > end:
            where = ("unaligned" if origin_ns is None
                     else _span_at(spans, origin_ns + int((start + end) / 2 * 1e3)))
            label = f"{where}>{group_of(name)}"
            gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
        end = stop if end is None else max(end, stop)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": union_us([(s, e) for s, e, _ in intervals]) / 1e6,
        "group_s": per_group,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[name[:120], s] for name, (s, _) in kernels[:top]],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top],
        },
    }
