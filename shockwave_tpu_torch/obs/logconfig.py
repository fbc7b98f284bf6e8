"""One-place logging configuration for the port's daemons (a copy of
`shockwave_tpu/obs/logconfig.py`): the worker daemon exposes
``--log_level`` and passes it to ``setup_logging``.
"""
from __future__ import annotations

import logging

#: Level names accepted by --log_level flags.
LEVELS = ("debug", "info", "warning", "error", "critical")

DEFAULT_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def setup_logging(level: str = "warning", fmt: str = DEFAULT_FORMAT) -> int:
    """Configure the root logger (handlers replaced, so repeated calls
    and prior ad-hoc basicConfig setups don't stack). Returns the
    numeric level. Raises ValueError on an unknown level name."""
    name = str(level).strip().lower()
    if name not in LEVELS:
        raise ValueError(
            f"unknown log level {level!r} (choose from {', '.join(LEVELS)})")
    numeric = getattr(logging, name.upper())
    logging.basicConfig(level=numeric, format=fmt, force=True)
    return numeric
