#!/usr/bin/env python3
"""A3C RL workload (trace: "A3C"), on PyTorch.

The port of `shockwave_tpu/workloads/rl/main.py`, with its CLI: the trace
command is `python3 main.py --env PongDeterministic-v4 --workers 4
--amsgrad True` with `--max-steps` appended by the dispatcher. `--device`
(default `cuda`) chooses the card or, when asked, the CPU.

As in the reference, the actors are a batch dimension of the vectorized
grid environment (`models/a3c.py`), one tick is one n-step unroll plus
one update, and the lease iterator wraps the tick counter: one iterator
step is one update. The optimiser is the reference's, Adam without
AMSGrad, whatever `--amsgrad` says. The checkpoint holds the model,
Adam's state, the step and the state of the generator that draws the
actions and the environment resets; the environment itself restarts
from the seed at every dispatch, as in the reference.
"""
import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), *[".."] * 3))

import torch  # noqa: E402

from shockwave_tpu_torch.models.a3c import (  # noqa: E402
    ActorCritic, build_a3c_update, env_reset)
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    LoopJob, common_parser, parse_args, resolve_device, run_loop)

INFINITY = 10 ** 9


class _TickLoader:
    """An 'epoch' of update ticks for the lease iterator to meter; each
    tick is an empty batch."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self):
        return self._n

    def __iter__(self):
        return itertools.repeat((), self._n)


class A3CJob(LoopJob):
    """The actor-critic, its Adam, the environments and their generator."""

    def __init__(self, args, device):
        super().__init__(device)
        self.gen = torch.Generator(device=device).manual_seed(args.seed)
        self.model = ActorCritic(generator=torch.Generator().manual_seed(args.seed)).to(device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=args.lr)
        self.env_state = env_reset(self.gen, args.workers, device)
        self._update = build_a3c_update(self.model, self.optimizer, unroll=args.unroll)

    def train_step(self):
        self.env_state, metrics = self._update(self.env_state, self.gen)
        self.step += 1
        return metrics

    def state(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "rng": self.gen.get_state(), "step": self.step}

    def restore(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.gen.set_state(state["rng"].cpu())
        self.step = int(state["step"])


def build_job(argv=None):
    """(job, data loader, args) from the trace's CLI, built but not run."""
    p = common_parser("A3C", steps_args=("--max-steps",))
    p.add_argument("--env", default="PongDeterministic-v4",
                   help="kept for trace-command parity; the built-in "
                        "vectorized catch/pong environment is always used")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--amsgrad", default="True")
    p.add_argument("--unroll", type=int, default=20)
    p.add_argument("--seed", type=int, default=1)
    args = parse_args(p, argv)
    job = A3CJob(args, resolve_device(args.device))
    budget = args.num_steps if args.num_steps is not None else INFINITY
    return job, _TickLoader(budget), args


def main(argv=None):
    job, loader, args = build_job(argv)
    run_loop(job, args, loader)
    return job


if __name__ == "__main__":
    main()
