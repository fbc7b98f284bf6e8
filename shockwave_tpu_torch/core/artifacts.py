"""Timestamped raw-measurement artifacts.

The port of `shockwave_tpu/core/artifacts.py`: the same file name
(``<prefix>_<device>_<UTCstamp>.json``), the same ``measured_at`` key and
layout. Where the reference stamps the JAX version and device kind, this
stamps the card's name, the torch and CUDA versions, and the card's
`nvidia-smi --query-gpu=name,power.limit` line (its power limit bounds
every rate measured on it). A run on the CPU is stamped ``device: cpu``
and no `nvidia-smi` line.
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Optional


def save_measurement(dir_path: str, prefix: str, payload: dict,
                     device_kind: Optional[str] = None):
    """Write ``payload`` (stamped with provenance) to a timestamped JSON
    under ``dir_path``; returns (path, stamped_record). ``device_kind``
    defaults to the first CUDA card's name (which needs the card)."""
    import torch

    now = datetime.datetime.now(datetime.timezone.utc)
    if device_kind is None:
        device_kind = torch.cuda.get_device_name(0)
    smi = None
    if device_kind != "cpu":
        from ..profiling.device import nvidia_smi
        smi = nvidia_smi()
    record = {
        "device": device_kind,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "nvidia_smi": smi,
        "measured_at": now.isoformat(timespec="seconds"),
        **payload,
    }
    os.makedirs(dir_path, exist_ok=True)
    name = (f"{prefix}_{device_kind.replace(' ', '_')}_"
            f"{now.strftime('%Y%m%dT%H%M%SZ')}.json")
    path = os.path.join(dir_path, name)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return path, record
