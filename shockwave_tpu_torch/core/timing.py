"""Steady-state step time by two-point timing.

The port of `shockwave_tpu/core/timing.py`, with the same algorithm and
defaults. `marginal_step_time` runs two chained windows of n1 and n2
steps, each closed by reading one element of the last loss on the host,
and reports (T2 - T1) / (n2 - n1): the fixed cost of the closing read
appears in both windows and cancels, and what remains is the marginal
cost of a step. The windows grow until the marginal time covers
`min_marginal_s`.

On a local CUDA card `torch.cuda.synchronize` could close a window as
well; the two-point method is kept so that the port's rates measure the
same quantity as the JAX package's (e.g. `data/v5e_throughputs.json`).

`fetch_scalar` reads the element with `.item()`, a copy to the host that
waits on the current stream for every kernel the value depends on, so it
cannot return early.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Tuple


def fetch_scalar(value: Any):
    """One element of the tensor `value` as a Python number, forcing
    completion of every computation it depends on; None for None (no
    step has run)."""
    if value is None:
        return None
    return value.detach().reshape(-1)[0].item()


def marginal_step_time(step_fn: Callable[[Any, Any], Tuple[Any, Any]],
                       state: Any, batch: Any, n1: int = 10, n2: int = 40,
                       warmup: int = 5, min_marginal_s: float = 1.0,
                       max_total_steps: int = 20000) -> float:
    """Steady-state seconds per `step_fn(state, batch) -> (state, loss)`
    step. The loss must depend on the step's work (a trainer that updates
    its state in place returns itself as `state`), so the closing fetch
    waits for the whole window.

    Windows grow adaptively until the marginal time (T2 - T1) covers at
    least `min_marginal_s`: for fast steps, a short marginal window would
    drown in the jitter of the closing fetch.
    """
    # Normalize degenerate windows (e.g. a caller's --steps 1): the
    # method needs two windows with n2 > n1 or the ratio is undefined.
    n1 = max(int(n1), 1)
    if n2 <= n1:
        n2 = n1 * 4

    loss = None
    for _ in range(warmup):
        state, loss = step_fn(state, batch)
    fetch_scalar(loss)

    def window(iters: int, state: Any):
        start = time.perf_counter()
        loss = None
        for _ in range(iters):
            state, loss = step_fn(state, batch)
        fetch_scalar(loss)
        return time.perf_counter() - start, state

    while True:
        t1, state = window(n1, state)
        t2, state = window(n2, state)
        marginal = t2 - t1
        if marginal >= min_marginal_s or n2 >= max_total_steps:
            return max(marginal / (n2 - n1), 1e-9)
        # Estimate per-step cost generously (cap below by the observed
        # marginal) and rescale the windows to cover min_marginal_s.
        dt_est = max(marginal / (n2 - n1), 1e-6)
        n2 = min(int(min_marginal_s / dt_est * 1.5) + n1, max_total_steps)
        n1 = max(n2 // 4, 2)
        if n2 <= n1:  # keep the two windows distinct after rescaling
            n2 = n1 + 1
