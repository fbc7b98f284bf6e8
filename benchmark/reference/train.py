"""The reference's first training steps: SGD with momentum, as
`torch.optim.SGD(lr, momentum=0.9)` takes them (the momentum trace
starts at the first gradient, no dampening), and the readings that
`benchmark.check` compares.

The loss of a step is summed over the model's row blocks, each block's
gradient accumulated at 1 / count, so a batch too large for one float32
pass still gives the whole batch's loss and gradient.
"""
from __future__ import annotations

import torch


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().double()))


def train(model, spec, weights: dict, batches, optimizer: dict) -> dict:
    """Trains `model` from `weights` over `batches`, one step each, and
    returns the readings: each step's loss, every trainable tensor's
    first gradient norm and its gradient norm at every step, and every
    tensor's change over all the steps (the running statistics' too)."""
    trainable = {name for name, _, _, train in spec if train}
    params = {name: weights[name].detach().float().clone().requires_grad_(name in trainable)
              for name, _, _, _ in spec}
    state = {name: t for name, t in params.items() if name not in trainable}
    lr, momentum = optimizer["lr"], optimizer["momentum"]
    losses, step_norms, bufs = [], [], {}
    for step, batch in enumerate(batches):
        count = model.count(batch)
        total = 0.0
        for rows in model.row_blocks(batch):
            part = model.loss_sum(params, batch, rows, state)
            (part / count).backward()
            total = total + part.detach()
        losses.append(float(total / count))
        step_norms.append({name: norm(params[name].grad) for name in trainable})
        with torch.no_grad():
            for name in trainable:
                p = params[name]
                if step == 0:
                    bufs[name] = p.grad.clone()
                else:
                    bufs[name].mul_(momentum).add_(p.grad)
                p.add_(bufs[name], alpha=-lr)
                p.grad = None
    change = {name: norm(params[name] - weights[name].float()) for name, _, _, _ in spec}
    return {"losses": losses, "grad_norms": step_norms[0], "step_grad_norms": step_norms,
            "change_norms": change}
