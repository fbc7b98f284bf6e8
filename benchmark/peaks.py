"""The card's published peaks, its exponential rate and its power limit:
a frozen copy of the port's `profiling/device.py` tables.

A peak is looked up from the card's name; a card whose name does not
say "H100" has no row here, and asking for its peaks raises.
"""
from __future__ import annotations

import subprocess

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s.
# The SXM part is the H100 without a tag in its name.
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H100 SXM": (3.35e12, 989e12)}
NAME_TAGS = {"PCIe": "H100 PCIe", "NVL": "H100 NVL"}
# Exponentials (MUFU.EX2) an SM issues a clock on compute capability 9.0:
# 4 in each of its 4 quadrants (the CUDA C++ Programming Guide).
EX2_PER_CLOCK_PER_SM = 16


def peaks(name: str):
    """(variant, (peak bytes/s, peak dense bf16 FLOP/s)) of the card
    called `name`; raises ValueError for a card that is not an H100."""
    if "H100" not in name:
        raise ValueError(f"no published peaks for {name!r}: the table "
                         f"holds the H100 parts {sorted(PEAKS)}")
    variant = next((v for tag, v in NAME_TAGS.items() if tag in name), "H100 SXM")
    return variant, PEAKS[variant]


def _query(field: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def nvidia_smi() -> str:
    """The first card's name and power limit, e.g. "NVIDIA H100 80GB
    HBM3, 700.00 W"."""
    return _query("name,power.limit")


def exp_rate(sms: int) -> float:
    """Exponentials a second on `sms` SMs at the card's highest SM clock
    (`clocks.max.sm`), the clock its peak rates assume."""
    mhz = float(_query("clocks.max.sm").split()[0])
    return EX2_PER_CLOCK_PER_SM * sms * mhz * 1e6
