"""A lease bounds how many steps / how long a job may run before it must
checkpoint and yield (reference: scheduler/lease.py)."""
from dataclasses import dataclass


@dataclass
class Lease:
    max_steps: float
    max_duration: float
