"""The card a measurement ran on: its `nvidia-smi` name, power limit and
highest SM clock, its published peak rates and its exponential rate; and
the one CUDA-graph timer of the kernels' measurements (`graph_ms`).

One table for `chip_smoke.py` and the profilers. A peak is looked up
from the card's name; a card whose name does not say "H100" has no row
here, and asking for its peaks raises (no rate is assumed for it).
"""
from __future__ import annotations

import statistics
import subprocess

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s.
# The SXM part is the H100 without a tag in its name; the others are told
# apart by their names.
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H100 SXM": (3.35e12, 989e12)}
NAME_TAGS = {"PCIe": "H100 PCIe", "NVL": "H100 NVL"}
# Published f32 FLOP/s outside the tensor cores (the SIMT cores), by part.
F32_FLOPS = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100 SXM": 67e12}
# Published dense TF32 tensor-core FLOP/s, by part: half the bf16 rate.
TF32_FLOPS = {"H100 PCIe": 378e12, "H100 NVL": 417.5e12, "H100 SXM": 494.5e12}


# Exponentials (MUFU.EX2, the special-function units) an SM issues a
# clock on compute capability 9.0: 4 in each of its 4 quadrants (the CUDA
# C++ Programming Guide's throughput table).
EX2_PER_CLOCK_PER_SM = 16


def exp_rate(sms: int, clock_hz: float) -> float:
    """Exponentials a second on `sms` SMs at `clock_hz`."""
    return EX2_PER_CLOCK_PER_SM * sms * clock_hz


def max_sm_clock_hz() -> float:
    """The first card's highest SM clock (`nvidia-smi`'s clocks.max.sm),
    Hz: the clock the card's peak rates assume."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def nvidia_smi() -> str:
    """The first card's `nvidia-smi --query-gpu=name,power.limit` line,
    e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def peaks(name: str):
    """(variant, (peak bytes/s, peak dense bf16 FLOP/s)) of the card
    called `name`; raises ValueError for a card that is not an H100."""
    if "H100" not in name:
        raise ValueError(f"no published peaks for {name!r}: the table "
                         f"holds the H100 parts {sorted(PEAKS)}")
    variant = next((v for tag, v in NAME_TAGS.items() if tag in name), "H100 SXM")
    return variant, PEAKS[variant]


def f32_product_flops(name: str) -> float:
    """The rate at which the card called `name` does f32-accurate products
    on its tensor cores, FLOP/s: a third of its dense TF32 rate, since
    3xTF32 runs three TF32 products for each f32 one (big.big + big.small
    + small.big). The least time an f32 product can take on the card is
    reckoned at this rate. Raises ValueError for a card that is not an
    H100."""
    variant, _ = peaks(name)
    return TF32_FLOPS[variant] / 3


def graph_ms(fn, inner: int = 20, reps: int = 7, replay_ms: float = 20.0) -> float:
    """Median device milliseconds of one call of `fn` on the card: `inner`
    calls are captured in a CUDA graph, which is replayed `reps` times
    between CUDA events after a warm-up. A call that takes more than
    `replay_ms / inner` (the milliseconds-long ones at D 256 and 512) is
    captured fewer times, as many as take about `replay_ms`, at least
    once: its launch cost is already a small share of it. `chip_smoke.py`
    and `fwd_wide_ab.py` time with it."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    inner = max(1, min(inner, int(replay_ms / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times)
