"""The comparison that decides `correct`: the program's first three
training steps against the plain reference's, from the same weights on
the same batches.

Readings, on either side: each step's loss, each trainable tensor's
first gradient norm (on the program's side, read from the optimizer's
momentum buffer after one step, which holds the gradient as the
optimizer got it), and each tensor's change over the three steps (the
running statistics too), read before a fourth step. Compared:

- `loss_gap`: the largest |loss - reference| / reference over the steps;
- `grad_gap`: over the tensors, the largest gap between the two first
  gradient norms, over the reference's norm of that tensor or of the
  median tensor, whichever is larger;
- `change_gap`: the same for the change over the three steps;
- `change_gap_median`: the median tensor's change gap, over the larger of
  its own norm and the median tensor's; steady from seed to seed where
  the worst tensor's gap is bf16's noise.

A tensor whose reference gradient is under `GRAD_FLOOR` of the median
tensor's (the median over the tensors with a gradient) is left out of
`grad_gap`, and out of `change_gap` where that holds at every step: a
key's bias under softmax is nought but rounding and moves by round-off
alone. A tensor whose first gradient is exactly nought (a ResNet block
behind its zero BatchNorm scale) still counts in the change once a later
step moves it; running statistics have no gradient and always count. Each number has its limit in
`benchmark/limits/<workload>.json`, set from readings of sound runs and
of the control (see PERF.md); a cell compares the numbers its limits
name.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_gap_median")
GRAD_FLOOR = 1e-3


def _gaps(prog: dict, ref: dict, names):
    """(the largest gap, its tensor, the median gap) over `names`."""
    scale = statistics.median(ref[n] for n in names)
    gaps = {}
    for n in names:
        gap = abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], scale)
        gaps[n] = gap if math.isfinite(gap) else math.inf
    worst = max(gaps, key=gaps.__getitem__)
    return gaps[worst], worst, statistics.median(gaps.values())


def _above_floor(norms: dict) -> list:
    """The tensors whose gradient norm is at least `GRAD_FLOOR` of the
    median over the tensors with a gradient."""
    nonzero = [g for g in norms.values() if g > 0]
    floor = GRAD_FLOOR * statistics.median(nonzero) if nonzero else math.inf
    return [n for n, g in norms.items() if g >= floor]


def compare(prog: dict, ref: dict):
    """({number: reading}, {number: the tensor or step that set it})."""
    grads = ref["grad_norms"]
    kept = _above_floor(grads)
    steps = [set(_above_floor(g)) for g in ref["step_grad_norms"]]
    moved = [n for n in ref["change_norms"] if n not in grads or any(n in s for s in steps)]
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    if len(loss_gaps) != len(ref["losses"]) or not all(map(math.isfinite, loss_gaps)):
        loss_gaps.append(math.inf)
    step = max(range(len(loss_gaps)), key=loss_gaps.__getitem__)
    grad_gap, grad_at, _ = _gaps(prog["grad_norms"], grads, kept)
    change_gap, change_at, change_median = _gaps(prog["change_norms"], ref["change_norms"], moved)
    return ({"loss_gap": loss_gaps[step], "grad_gap": grad_gap, "change_gap": change_gap,
             "change_gap_median": change_median},
            {"loss_gap": f"step {step + 1}", "grad_gap": grad_at, "change_gap": change_at,
             "left_out": sorted(set(grads) - set(kept)),
             "left_out_of_change": sorted(set(grads) - set(moved))})


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every number that `limits` names is within its limit."""
    return all(numbers[k] <= limit for k, limit in limits.items())
