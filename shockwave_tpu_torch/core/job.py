"""Job identity and description (a copy of `shockwave_tpu/core/job.py`).

`JobIdPair` is the hashable key used throughout the scheduler: either a
single job id or an (unordered) pair of co-located jobs. Behavioral parity
with reference scheduler/job_id_pair.py; the pairing-function hash and
ordering semantics are preserved because policy code sorts on these keys.

`Job` carries everything the scheduler needs to dispatch and account for a
training job (reference: scheduler/job.py). Commands are stored as shell
strings whose final batch-size token can be rewritten on dynamic adaptation.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple


class JobIdPair:
    """A single job id, or an unordered pair of co-located job ids."""

    __slots__ = ("_lo", "_hi", "_hash", "_singles")

    #: `_singles` is an idempotent lazy memo over immutable inputs
    #: (_lo/_hi never change): two threads racing the first
    #: `singletons()` call compute the same tuple and the losing write
    #: is identical — benign by construction (race-detector verdict).
    _EXTERNALLY_SYNCHRONIZED = frozenset({"_singles"})

    def __init__(self, a: Optional[int], b: Optional[int] = None):
        if a is None:
            raise ValueError("first id of a JobIdPair must not be None")
        if b is None:
            self._lo, self._hi = a, None
            self._hash = a
        else:
            self._lo, self._hi = (a, b) if a <= b else (b, a)
            # Pairing function matching the reference's hash; collisions with
            # small single ids exist but __eq__ disambiguates.
            self._hash = self._lo + self._hi * self._hi
        self._singles = None

    def __getitem__(self, i: int) -> Optional[int]:
        if i == 0:
            return self._lo
        if i == 1:
            return self._hi
        raise IndexError(i)

    def is_pair(self) -> bool:
        return self._hi is not None

    def singletons(self) -> Tuple["JobIdPair", ...]:
        if self._singles is None:
            if self._hi is None:
                self._singles = (self,)
            else:
                self._singles = (JobIdPair(self._lo), JobIdPair(self._hi))
        return self._singles

    def as_tuple(self):
        return (self._lo, self._hi)

    def as_set(self):
        return {self._lo, self._hi}

    def overlaps_with(self, other: "JobIdPair") -> bool:
        if self.is_pair():
            raise ValueError("overlaps_with is only valid on single ids")
        return self._lo == other._lo or self._lo == other._hi

    def integer_job_id(self) -> int:
        assert self._hi is None, "not a single job id"
        return self._lo

    def __eq__(self, other) -> bool:
        if isinstance(other, int):
            return self._lo == other and self._hi is None
        return self._lo == other._lo and self._hi == other._hi

    def __lt__(self, other: "JobIdPair") -> bool:
        # Singles sort before pairs; otherwise lexicographic.
        if other._hi is not None:
            if self._hi is None:
                return True
            if self._lo == other._lo:
                return self._hi < other._hi
        elif self._hi is not None:
            return False
        return self._lo < other._lo

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        if self._hi is None:
            return str(self._lo)
        return f"({self._lo}, {self._hi})"


class Job:
    """Description of one training job.

    job_type has the canonical form "<Model> (batch size <N>)"; the model
    and batch size are recoverable from it, and `with_batch_size` rewrites
    both the type string and the trailing batch-size token of the command.
    """

    def __init__(
        self,
        job_id: Optional[JobIdPair],
        job_type: str,
        command: str,
        working_directory: str = "",
        num_steps_arg: str = "--num_steps",
        total_steps: int = 0,
        duration: float = 0,
        scale_factor: int = 1,
        mode: str = "static",
        priority_weight: float = 1.0,
        SLO: Optional[float] = None,
        needs_data_dir: bool = False,
        mps_thread_percentage: int = 100,
    ):
        self.job_id = job_id
        self.job_type = job_type
        self.command = command
        self.working_directory = working_directory
        self.num_steps_arg = num_steps_arg
        self.total_steps = int(total_steps)
        self._duration = duration
        self.scale_factor = int(scale_factor)
        self.mode = mode
        self.priority_weight = priority_weight
        self.SLO = None if (SLO is not None and SLO < 0) else SLO
        self.needs_data_dir = needs_data_dir
        self.mps_thread_percentage = mps_thread_percentage

    @property
    def duration(self) -> int:
        return int(float(self._duration))

    @duration.setter
    def duration(self, v):
        self._duration = v

    @property
    def model(self) -> str:
        return self.job_type.split(" ", 1)[0]

    @property
    def batch_size(self) -> int:
        m = re.search(r"batch size (\d+)\)", self.job_type)
        if m is None:
            from .constants import DEFAULT_BS
            if self.model in DEFAULT_BS:
                return DEFAULT_BS[self.model]
            raise ValueError(f"job_type has no batch size: {self.job_type!r}")
        return int(m.group(1))

    def update_bs(self, new_bs: int) -> None:
        """Rewrite batch size in the job type and launch command.

        The batch size is the last numeric token of the command for most
        workloads; translation/imagenet commands carry a trailing data path,
        so there it is the second-to-last token (reference: job.py:142-166).
        """
        tokens = self.command.split(" ")
        idx = -1 if ("translation" not in self.command and "imagenet" not in self.command) else -2
        tokens[idx] = str(new_bs)
        self.command = " ".join(tokens)
        self.job_type = re.sub(r"batch size \d+\)", f"batch size {new_bs})", self.job_type)

    def __repr__(self) -> str:
        return f"Job({self.job_id}, {self.job_type!r}, sf={self.scale_factor}, mode={self.mode})"
