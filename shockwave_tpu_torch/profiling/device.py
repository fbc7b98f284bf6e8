"""The card a measurement ran on: its `nvidia-smi` name and power limit,
and its published peak rates.

One table for `chip_smoke.py` and the profilers. A peak is looked up
from the card's name; a card whose name does not say "H100" has no row
here, and asking for its peaks raises (no rate is assumed for it).
"""
from __future__ import annotations

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
